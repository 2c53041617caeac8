"""Sphere geometry of the PyTorch port against the JAX package.

The same numpy inputs (seeded) go through `spheremanopt_tpu.manifold.
sphere` and `spheremanopt_torch.manifold.sphere` in f64. Tolerance
rel 1e-14: the formulas are op-for-op identical, so only the summation
order inside the inner products (a few ulp) can differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.manifold import sphere as tgeom
from spheremanopt_tpu.manifold import sphere as jgeom

RTOL = 1e-14
RADIUS = 0.0725

IPS = {
    "dot": (jnp.dot, torch.dot),
    "mean": (lambda x, y: jnp.mean(x * y), lambda x, y: torch.mean(x * y)),
}


def _vecs(n=3, dim=64, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(dim) for _ in range(n)]


def _close(j, t, rtol=RTOL):
    j, t = np.asarray(j, np.float64), t.detach().numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * np.abs(j).max())


CASES = {
    "normalise_sphere": lambda g, ip, x, v, d: g.normalise_sphere(x, RADIUS, ip),
    "retract": lambda g, ip, x, v, d: g.retract(x, 0.37, d, RADIUS, ip),
    "tangent_project": lambda g, ip, x, v, d: g.tangent_project(x, v, ip),
    "transport": lambda g, ip, x, v, d: g.transport(x, v, ip),
}


@pytest.mark.parametrize("ip_name", sorted(IPS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_geometry_matches_jax(name, ip_name):
    x, v, d = _vecs()
    jip, tip = IPS[ip_name]
    fn = CASES[name]
    j = fn(jgeom, jip, *map(jnp.asarray, (x, v, d)))
    t = fn(tgeom, tip, *map(torch.as_tensor, (x, v, d)))
    _close(j, t)


MULTI = {
    "normalise_multi": lambda g, ip, xs, vs, ds: g.normalise_multi(xs, [1.0, RADIUS], ip),
    "retract_multi": lambda g, ip, xs, vs, ds: g.retract_multi(xs, 0.2, ds, [1.0, RADIUS], ip),
    "tangent_project_multi": lambda g, ip, xs, vs, ds: g.tangent_project_multi(xs, vs, ip),
    "transport_multi": lambda g, ip, xs, vs, ds: g.transport_multi(xs, vs, ip),
    "directional_inner": lambda g, ip, xs, vs, ds: [g.directional_inner(vs, ds, ip)],
}


@pytest.mark.parametrize("name", sorted(MULTI))
def test_multi_sphere_matches_jax(name):
    """Two components with per-component inner products."""
    vecs = _vecs(6, seed=1)
    j_ips = [IPS["dot"][0], IPS["mean"][0]]
    t_ips = [IPS["dot"][1], IPS["mean"][1]]
    groups = [vecs[0:2], vecs[2:4], vecs[4:6]]
    j = MULTI[name](jgeom, j_ips, *[[jnp.asarray(a) for a in g] for g in groups])
    t = MULTI[name](tgeom, t_ips, *[[torch.as_tensor(a) for a in g] for g in groups])
    assert len(j) == len(t)
    for a, b in zip(j, t):
        _close(a, b)


def test_retract_lands_on_sphere():
    x, _, d = (torch.as_tensor(a) for a in _vecs())
    y = tgeom.retract(tgeom.normalise_sphere(x, RADIUS, torch.dot), 0.37, d,
                      RADIUS, torch.dot)
    assert abs(float(torch.dot(y, y)) - RADIUS) < 1e-14


def test_inner_product_list_length_validated():
    xs = [torch.ones(4), torch.ones(4)]
    with pytest.raises(ValueError, match="expected 2 inner products"):
        tgeom.normalise_multi(xs, [1.0, 1.0], [torch.dot])
