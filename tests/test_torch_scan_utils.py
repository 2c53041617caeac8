"""The port's trajectory-memory policies (`solvers/scan_utils.py`) against
the JAX package's, live on the CPU, on the JAX tests' toy recurrence:

  * `nested_checkpoint_scan` vs a plain loop and vs the JAX function: the
    carry and the sum rel 1e-12 (the JAX test's tolerance), the series in
    flat step order; its gradient vs store-all and vs JAX's rel 1e-11;
  * `offload_checkpoint` bitwise per-step checkpointing, and vs
    store-all: value bitwise, gradient rel 1e-12; on the CPU its host copy
    is a plain copy;
  * one `host_copy` shared by two checkpointed functions of a carry: the
    carry's cotangents summed on the host copy, the gradient store-all's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from spheremanopt_torch.solvers.scan_utils import (checkpoint_on_host,
                                                   host_copy,
                                                   nested_checkpoint_scan,
                                                   offload_checkpoint)
from spheremanopt_tpu.solvers.scan_utils import \
    nested_checkpoint_scan as j_nested


def _step(c):
    c2 = 0.97 * c + 0.05 * torch.tanh(c)
    return c2, torch.sum(c2 * c2)


def _jstep(c):
    c2 = 0.97 * c + 0.05 * jnp.tanh(c)
    return c2, jnp.sum(c2 * c2)


def _c0(n=32):
    return np.linspace(-1.0, 1.0, n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("length,inner", [(9, None), (16, None), (37, None),
                                          (37, 5), (3, 7)])
def test_nested_scan_matches_plain_loop_and_jax(length, inner):
    c_ref, tot_ref, ys = torch.tensor(_c0()), 0.0, []
    for _ in range(length):
        c_ref, y = _step(c_ref)
        tot_ref += float(y)
        ys.append(float(y))
    c, tot, series = nested_checkpoint_scan(_step, torch.tensor(_c0()), length,
                                            inner=inner, return_series=True)
    assert _rel(c, c_ref) < 1e-12 and abs(float(tot) / tot_ref - 1) < 1e-12
    assert series.shape == (length,) and _rel(series, ys) < 1e-14
    cj, totj, sj = j_nested(_jstep, jnp.asarray(_c0()), length, inner=inner,
                            return_series=True)
    assert _rel(c, cj) < 1e-12 and abs(float(tot) / float(totj) - 1) < 1e-12
    assert _rel(series, sj) < 1e-12
    # the series flag does not change the arithmetic
    c2, tot2 = nested_checkpoint_scan(_step, torch.tensor(_c0()), length, inner=inner)
    assert torch.equal(c2, c) and torch.equal(tot2, tot)


def test_nested_scan_gradient_matches_storeall_and_jax():
    length = 25
    c0 = torch.tensor(_c0(16), requires_grad=True)
    (g1,) = torch.autograd.grad(nested_checkpoint_scan(_step, c0, length)[1], c0)
    c, tot = c0, 0.0
    for _ in range(length):
        c, y = _step(c)
        tot = tot + y
    (g2,) = torch.autograd.grad(tot, c0)
    assert _rel(g1, g2) < 1e-11
    gj = jax.grad(lambda c: j_nested(_jstep, c, length)[1])(jnp.asarray(_c0(16)))
    assert _rel(g1, gj) < 1e-11


def test_nested_scan_stores_carries_per_chunk():
    """Under autograd the chunks and the steps in them are checkpointed: the
    forward keeps only the chunks' inputs and the remainder steps' (one
    stored carry each), not every step's."""
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    c0 = torch.tensor(_c0(64), requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        nested_checkpoint_scan(_step, c0, 30)           # inner 5, 6 chunks
    big = sum(1 for n in saved if n == 64)
    assert big <= 2 * 6, big   # vs >= 3 x 30 for store-all


@pytest.mark.parametrize("with_rest", [False, True])
def test_offload_matches_storeall(with_rest):
    w = torch.linspace(0.5, 1.5, 32, dtype=torch.float64, requires_grad=with_rest)

    def step(c, *rest):
        a = rest[0] if rest else 1.0
        return 0.97 * c * a + 0.05 * torch.tanh(c)

    def checkpointed(c, *r):
        return checkpoint(step, c, *r, use_reentrant=False)

    rest = (w,) if with_rest else ()
    ref = []
    for wrapped in (offload_checkpoint(step), checkpointed, step):
        c0 = torch.tensor(_c0(), requires_grad=True)
        c = c0
        for _ in range(12):
            c = wrapped(c, *rest)
        J = torch.sum(c * c)
        ref.append((J.detach(), torch.autograd.grad(J, (c0,) + rest)))
    (J1, g1), (J2, g2), (J3, g3) = ref
    assert torch.equal(J1, J2) and torch.equal(J1, J3)
    for a, b, c in zip(g1, g2, g3):
        assert torch.equal(a, b) and _rel(a, c) < 1e-12


def test_offload_recomputes_from_a_host_copy_and_runs_plainly_without_grad():
    seen = []

    def step(c):
        seen.append((c.data_ptr(), c.stride(), torch.is_grad_enabled()))
        return c * c

    f = offload_checkpoint(step)
    c0 = torch.ones(3, 4, dtype=torch.float64).t().requires_grad_(True)
    out = f(c0)
    (g,) = torch.autograd.grad(out.sum(), c0)
    assert torch.equal(g, torch.full((4, 3), 2.0, dtype=torch.float64))   # 2 c
    # forward and recompute both run on the copy (a CPU carry's host copy
    # is a plain copy), laid out as the carry
    assert len(seen) == 2 and seen[0][0] == seen[1][0] != c0.data_ptr()
    assert seen[0][1] == seen[1][1] == c0.stride()
    seen.clear()
    with torch.no_grad():
        assert f(c0).grad_fn is None
    assert f(torch.ones(4)).grad_fn is None   # nothing to differentiate
    assert [s[0] for s in seen] != [] and seen[0][0] == c0.data_ptr()


def test_one_host_copy_serves_two_functions_of_a_carry():
    """A carry's energy and its step checkpointed on one shared host copy
    (the Integrated cost under remat="offload"): the value and the gradient
    as store-all's, and the carry's two cotangents summed on the host copy
    (the device never holds one of them waiting for the other)."""
    def step(c):
        return 0.97 * c + 0.05 * torch.tanh(c)

    def energy(c):
        return torch.sum(c * c)

    out = []
    for shared in (True, False):
        c0 = torch.tensor(_c0(), requires_grad=True)
        c, J, hosts = c0, 0.0, []
        for _ in range(6):
            if shared:
                h = host_copy(c)
                h.register_hook(lambda g, _h=h: hosts.append(g.device.type))
                J = J + checkpoint_on_host(energy, h, c.device)
                c = checkpoint_on_host(step, h, c.device)
            else:
                J = J + energy(c)
                c = step(c)
        J = J + energy(c)
        out.append((J.detach(), torch.autograd.grad(J, c0)[0]))
        if shared:
            assert hosts == ["cpu"] * 6
    (J1, g1), (J2, g2) = out
    assert torch.equal(J1, J2)
    assert _rel(g1, g2) < 1e-12

