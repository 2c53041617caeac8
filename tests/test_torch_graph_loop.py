"""CUDA-graph replay of the device loops (`spheremanopt_torch/optim/graph_loop.py`).

On the CPU: the loop's bookkeeping (operand trees, the copy of a step's
outputs into the state's buffers when one output is another entry's
buffer). On the card (`requires_cuda`; the card's machine has no JAX, so
this file imports none: run it with
`python -m pytest --noconftest -m requires_cuda tests/test_torch_graph_loop.py`):
the device loop on CUDA graphs against the same steps run eagerly
(`graphs=False`) on SH23 and SHB23 through their kernels at small widths,
bit for bit; the kernels' launch counts through replays; device RTR on
graphs against its eager steps; and a step that cannot be captured
raising instead of falling back.
"""

import numpy as np
import pytest
import torch

from spheremanopt_torch.optim.graph_loop import GraphLoop, tree_flatten


def test_tree_flatten_round_trip():
    a, b = torch.zeros(2), torch.ones(3)
    tree = {"m": [a, (b, 2.5)], "s": "name"}
    leaves, rebuild = tree_flatten(tree)
    assert leaves[0] is a and leaves[1] is b and len(leaves) == 2
    c, d = torch.full((2,), 7.0), torch.full((3,), 8.0)
    out = rebuild([c, d])
    assert out["m"][0] is c and out["m"][1][0] is d
    assert out["m"][1][1] == 2.5 and out["s"] == "name"
    assert tree_flatten(None)[0] == []


def test_outputs_that_alias_state_buffers_are_copied_first():
    """A step that passes an entry on under another name (ds_old = ds)
    while replacing it (ds = new) must leave the old values in ds_old
    whatever the order of the copies: the state's buffers are written
    in place, as a CUDA graph writes them."""
    def shift(S):
        return dict(ds=[S["ds"][0] + 1.0], ds_old=S["ds"], flag=S["flag"])

    L = GraphLoop({"shift": shift}, ("shift",), graphs=True)
    L.S.update(ds=[torch.zeros(3)], ds_old=[torch.full((3,), -1.0)],
               flag=torch.zeros((), dtype=torch.int64))
    buf = L.S["ds"][0]
    L._eager("shift")
    L._eager("shift")
    assert L.S["ds"][0] is buf                      # written in place
    assert torch.equal(L.S["ds"][0], torch.full((3,), 2.0))
    assert torch.equal(L.S["ds_old"][0], torch.full((3,), 1.0))


def test_eager_loop_counts_steps():
    def step(S):
        return dict(n=S["n"] + 1, flag=(S["n"] + 1 < 3).to(torch.int64))

    L = GraphLoop({"step": step}, ("step",), graphs=False)
    L.S["n"] = torch.zeros((), dtype=torch.int64)
    while L.run("step"):
        pass
    assert int(L.S["n"]) == 3 and L.replays["step"] == 3


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels "
                    "have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(name, cuda):
    if name == "sh23":
        from spheremanopt_torch.problems.swift_hohenberg import (
            SH23Config, SwiftHohenberg)

        p = SwiftHohenberg(SH23Config(npts=64, n_iters=100, dtype="float32",
                                      method="cuda"), device=cuda)
        return p, p.generate_ic(seed=3), float(np.pi), (
            "fused_fwd_shared_grid", "fused_bwd_shared")
    from spheremanopt_torch.problems.swift_hohenberg_bounded import (
        SHB23Config, SwiftHohenbergBounded)

    p = SwiftHohenbergBounded(SHB23Config(npts=128, n_iters=200,
                                          dtype="float32", method="cuda"),
                              device=cuda)
    return p, p.generate_ic(seed=3), 1.0, ("fused_fwd_grid", "fused_bwd")


def _launches():
    from spheremanopt_torch.ops.cuda import fused_two_matrix as fk
    from spheremanopt_torch.ops.cuda import kdyn_step as kd

    return {**fk.LAUNCHES, **kd.LAUNCHES}


def _reset():
    from spheremanopt_torch.ops.cuda import fused_two_matrix as fk
    from spheremanopt_torch.ops.cuda import kdyn_step as kd

    fk.reset_launches()
    kd.reset_launches()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", ["sh23", "shb23"])
@pytest.mark.parametrize("ls", ["wolfe", "armijo"])
def test_graphs_match_eager_steps_bitwise(cuda, name, ls):
    from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere

    p, x0, alpha0, kernels = _problem(name, cuda)
    kw = dict(max_iters=6, alpha0=alpha0, line_search=ls, f=p.objective)
    opt_g = jit_optimise_on_multi_sphere(p.objective_and_gradient,
                                         p.inner_product, p.radii, **kw)
    opt_e = jit_optimise_on_multi_sphere(p.objective_and_gradient,
                                         p.inner_product, p.radii,
                                         graphs=False, **kw)
    rg = opt_g(x0)                    # warm-up, capture, replays
    re = opt_e(x0)
    assert int(rg.iterations) >= 2
    assert torch.equal(rg.function_values, re.function_values)
    assert torch.equal(rg.step_sizes, re.step_sizes)
    assert torch.equal(rg.x_opt[0], re.x_opt[0])
    # a second call replays the captured graphs, counting their launches
    _reset()
    rg2 = opt_g(x0)
    torch.cuda.synchronize()
    L = opt_g.last_loop
    assert torch.equal(rg2.function_values, rg.function_values)
    counted = _launches()
    want = {}
    for step, n in L.replays.items():
        for k, d in L.graph_launches(step).items():
            want[k] = want.get(k, 0) + n * d
    assert {k: v for k, v in counted.items() if v} == want
    assert all(want.get(k, 0) > 0 for k in kernels), want


@pytest.mark.requires_cuda
def test_device_rtr_graphs_match_eager_steps(cuda):
    from spheremanopt_torch.optim.jit_rtr import jit_optimise_rtr
    from spheremanopt_torch.problems.swift_hohenberg import (
        SH23Config, SwiftHohenberg)

    p = SwiftHohenberg(SH23Config(npts=32, n_iters=30, dtype="float64"),
                       device=cuda)
    x0 = p.generate_ic(seed=2)
    kw = dict(err_tol=1e-6, max_iters=20)
    rg = jit_optimise_rtr(p.objective, p.gradient, p.inner_product, p.radii,
                          **kw)(x0)
    re = jit_optimise_rtr(p.objective, p.gradient, p.inner_product, p.radii,
                          graphs=False, **kw)(x0)
    assert bool(rg.converged) and int(rg.trials) == int(re.trials)
    assert torch.equal(rg.function_values, re.function_values)
    assert torch.equal(rg.x_opt[0], re.x_opt[0])


@pytest.mark.requires_cuda
def test_a_step_that_cannot_be_captured_raises(cuda):
    """A host read inside f_and_g cannot be captured: the optimiser
    raises, naming the step, and does not run eagerly instead."""
    from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere

    m = torch.randn(16, 16, dtype=torch.float64, device=cuda)
    m = m + m.T

    def f_and_g(xs):
        if float(xs[0].sum()) > 1e300:      # a host read: a sync
            raise AssertionError
        return -0.5 * xs[0] @ (m @ xs[0]), [-(m @ xs[0])]

    opt = jit_optimise_on_multi_sphere(f_and_g, torch.dot, [1.0], max_iters=3,
                                       line_search="wolfe")
    with pytest.raises(RuntimeError, match="CUDA graph capture of the step"):
        opt([torch.ones(16, dtype=torch.float64, device=cuda)])
