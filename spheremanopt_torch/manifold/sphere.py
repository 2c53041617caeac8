"""Spherical-manifold primitives, generic in the inner product.

PyTorch port of the JAX package's `manifold/sphere.py`, itself the
geometry contract of the reference optimiser
(`Sphere_Grad_Descent.py:625-690`): for a sphere of radius-squared M_0
under an arbitrary inner product <.,.>,

  retraction        R_x(a d)  = sqrt(M_0) * (x + a d) / ||x + a d||
  tangent project   P_x(v)    = v - (<x,v>/<x,x>) x
  vector transport  T_x(v)    = v - (<x,v>/<x,x>) x   (same formula; the
                    reference omits the sqrt(M_0)/||x|| scale since x is
                    always on the sphere when transport is applied)

All functions are plain tensor code and autograd-safe. The inner product
is a callable `(x, y) -> 0-dim tensor`; problems supply
quadrature-weighted versions so the geometry is metric-consistent with
the PDE objective (`FWD_Solve_SH23.py:158-172`).

Rows. The same functions serve a batch of independent points with a
leading row axis (a sweep): `x` is (R, ...), the inner product returns
one value per row, (R,), and radii and step sizes are (R,) or scalars.
`per_row` aligns such a per-row value with the row axis of a state
tensor.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

InnerProduct = Callable[..., torch.Tensor]


def per_row(s, like):
    """`s` shaped to broadcast against `like` along its leading axes: a
    per-row value (R,) becomes (R, 1, ...); a 0-dim tensor or a Python
    number is returned as it is."""
    if not isinstance(s, torch.Tensor) or s.dim() == 0 or s.dim() >= like.dim():
        return s
    return s.reshape(s.shape + (1,) * (like.dim() - s.dim()))


def normalise_sphere(x, radius, inner: InnerProduct):
    """Scale `x` onto the sphere <x,x> = radius
    (`Sphere_Grad_Descent.py:734`)."""
    return x * per_row(torch.sqrt(radius / inner(x, x)), x)


def retract(x, alpha, d, radius, inner: InnerProduct):
    """Retraction-based update: sqrt(radius)*(x + alpha*d)/||x + alpha*d||
    (`Update_vector`, `Sphere_Grad_Descent.py:661-690`)."""
    y = x + per_row(alpha, d) * d
    return y * per_row(torch.sqrt(radius / inner(y, y)), y)


def tangent_project(x, v, inner: InnerProduct):
    """Project Euclidean (co)vector `v` onto the tangent plane at `x`
    (`tangent_vector`, `Sphere_Grad_Descent.py:644-659`)."""
    return v - per_row(inner(x, v) / inner(x, x), x) * x


def transport(x, v, inner: InnerProduct):
    """Transport a tangent vector from the previous iterate's plane to x's
    (`transport_vector`, `Sphere_Grad_Descent.py:625-642`)."""
    return v - per_row(inner(x, v) / inner(x, x), x) * x


# ---------------------------------------------------------------------------
# Product-of-spheres (multi-sphere) versions. State is a list of 1-D
# tensors with one radius and one inner product per component.
# ---------------------------------------------------------------------------


def _as_list(inner, n: int) -> Sequence[InnerProduct]:
    if callable(inner):
        return [inner] * n
    ips = list(inner)
    if len(ips) != n:
        # the multi-sphere helpers zip components against this list; a
        # short list would silently DROP spheres (zip stops early)
        raise ValueError(
            f"expected {n} inner products (one per sphere), got {len(ips)}")
    return ips


def normalise_multi(xs, radii, inner):
    ips = _as_list(inner, len(xs))
    return [normalise_sphere(x, r, ip) for x, r, ip in zip(xs, radii, ips)]


def retract_multi(xs, alpha, ds, radii, inner):
    ips = _as_list(inner, len(xs))
    return [
        retract(x, alpha, d, r, ip)
        for x, d, r, ip in zip(xs, ds, radii, ips)
    ]


def tangent_project_multi(xs, vs, inner):
    ips = _as_list(inner, len(xs))
    return [tangent_project(x, v, ip) for x, v, ip in zip(xs, vs, ips)]


def transport_multi(xs, vs, inner):
    ips = _as_list(inner, len(xs))
    return [transport(x, v, ip) for x, v, ip in zip(xs, vs, ips)]


def directional_inner(gs, ds, inner):
    """Sum of per-sphere inner products: the slope phi'(0) = <g, d>
    (`Sphere_Grad_Descent.py:129-132`)."""
    ips = _as_list(inner, len(gs))
    total = 0.0
    for g, d, ip in zip(gs, ds, ips):
        total = total + ip(g, d)
    return total


def sphere_error(xs, radii, inner) -> float:
    """max over the spheres of |<x_i, x_i> / r_i - 1|: how far a state
    lies off its spheres (a Python float)."""
    ips = _as_list(inner, len(xs))
    return max(abs(float(ip(x, x)) / float(r) - 1.0) for x, r, ip in zip(xs, radii, ips))
