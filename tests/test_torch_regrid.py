"""Spectral resolution continuation of the port (`spheremanopt_torch/
utils/regrid.py`) against the JAX package's `utils/regrid.py`.

For SH23, SHB23, KDyn (both spheres) and mixing, the same numpy state
regridded coarse to fine and fine to coarse by both packages agrees to
1e-12 (f64), lands on the port problem's spheres to 1e-12, and a round
trip returns the renormalised source. `reshape_flat_state` shapes the
flat vectors of a reference `DAL_PROGRESS.h5` as JAX's does, passes
shaped and regrid-source states through, and refuses a wrong size.
KDyn's distributed target (a 2-rank gloo world) gives the full grid
layout, and its objective at the regridded state matches the matmul
target's.
"""

import numpy as np
import pytest
import torch

from spheremanopt_torch.utils import regrid as treg
from spheremanopt_tpu.utils import regrid as jreg

TOL = 1e-12


def _pair(name, coarse):
    """(JAX problem, port problem) of one family at the coarse or fine
    size, f64."""
    if name == "sh23":
        from spheremanopt_torch.problems.swift_hohenberg import SH23Config as TC
        from spheremanopt_torch.problems.swift_hohenberg import SwiftHohenberg as TP
        from spheremanopt_tpu.problems.swift_hohenberg import SH23Config as JC
        from spheremanopt_tpu.problems.swift_hohenberg import SwiftHohenberg as JP

        cfg = dict(npts=32 if coarse else 48, n_iters=4)
    elif name == "shb23":
        from spheremanopt_torch.problems.swift_hohenberg_bounded import SHB23Config as TC
        from spheremanopt_torch.problems.swift_hohenberg_bounded import (
            SwiftHohenbergBounded as TP)
        from spheremanopt_tpu.problems.swift_hohenberg_bounded import SHB23Config as JC
        from spheremanopt_tpu.problems.swift_hohenberg_bounded import (
            SwiftHohenbergBounded as JP)

        cfg = dict(npts=32 if coarse else 48, n_iters=4)
    elif name == "kdyn":
        from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig as TC
        from spheremanopt_torch.problems.kinematic_dynamo import KinematicDynamo as TP
        from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig as JC
        from spheremanopt_tpu.problems.kinematic_dynamo import KinematicDynamo as JP

        cfg = dict(npts=8 if coarse else 12, n_iters=2, dt=1e-3)
    else:
        from spheremanopt_torch.problems.optimal_mixing import MixingConfig as TC
        from spheremanopt_torch.problems.optimal_mixing import OptimalMixing as TP
        from spheremanopt_tpu.problems.optimal_mixing import MixingConfig as JC
        from spheremanopt_tpu.problems.optimal_mixing import OptimalMixing as JP

        cfg = dict(nx=16 if coarse else 24, nz=8 if coarse else 16, n_iters=2,
                   prep_steps=2)
    return JP(JC(**cfg)), TP(TC(**cfg), device="cpu")


@pytest.fixture(scope="module")
def problems():
    return {(n, c): _pair(n, c) for n in ("sh23", "shb23", "kdyn", "mixing")
            for c in (True, False)}


def _state(jp):
    return [np.array(x, np.float64) for x in jp.generate_ic(seed=3)]


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("name", ["sh23", "shb23", "kdyn", "mixing"])
@pytest.mark.parametrize("direction", ["up", "down"])
def test_regrid_matches_jax_and_lands_on_the_spheres(problems, name, direction):
    src_coarse = direction == "up"
    jsrc, _ = problems[(name, src_coarse)]
    jdst, tdst = problems[(name, not src_coarse)]
    x = _state(jsrc)
    got = treg.regrid_state(tdst, x)
    want = jreg.regrid_state(jdst, x)
    assert [g.shape for g in got] == [np.shape(w) for w in want]
    assert [g.shape for g in got] == [tuple(s) for s in treg.expected_state_shapes(tdst)]
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        assert _rel(g, w) <= TOL
    for g, r in zip(got, tdst.radii):
        t = torch.as_tensor(g)
        assert abs(float(tdst.inner_product(t, t)) / r - 1.0) <= TOL
    raw = treg.regrid_state(tdst, x, renormalise=False)
    for g, w in zip(raw, jreg.regrid_state(jdst, x, renormalise=False)):
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("name", ["sh23", "shb23", "kdyn", "mixing"])
def test_regrid_round_trip(problems, name):
    """Coarse -> fine -> coarse returns the source on its spheres (the
    fine grid represents the band-limited state exactly)."""
    jc, tc = problems[(name, True)]
    _, tf = problems[(name, False)]
    x = _state(jc)
    back = treg.regrid_state(tc, treg.regrid_state(tf, x))
    want = treg.regrid_state(tc, x)
    for b, w in zip(back, want):
        assert _rel(b, w) <= 1e-10


@pytest.mark.parametrize("name", ["sh23", "shb23", "kdyn", "mixing"])
def test_reshape_flat_state_matches_jax(problems, name):
    jp, tp = problems[(name, True)]
    assert treg.expected_state_shapes(tp) == jreg.expected_state_shapes(jp)
    ic = _state(jp)
    flat = [x.ravel() for x in ic]     # Field_to_Vec byte order
    got = treg.reshape_flat_state(tp, flat)
    for g, w, x in zip(got, jreg.reshape_flat_state(jp, flat), ic):
        assert g.shape == np.shape(w) == x.shape and np.array_equal(g, x)
    # tensors and shaped states pass through
    shaped = treg.reshape_flat_state(tp, [torch.as_tensor(x) for x in ic])
    assert all(np.array_equal(a, b) for a, b in zip(shaped, ic))


def test_reshape_flat_state_regrid_sources_and_refusals(problems):
    _, tk = problems[("kdyn", True)]
    v = np.arange(3 * 6 ** 3, dtype=np.float64)      # another mg's flat cube
    assert treg.reshape_flat_state(tk, [v, v])[0].shape == (3, 6, 6, 6)
    _, ts = problems[("sh23", True)]
    assert treg.reshape_flat_state(ts, [np.arange(20.0)])[0].shape == (20,)
    _, tm = problems[("mixing", True)]
    with pytest.raises(ValueError, match="does not match the expected"):
        treg.reshape_flat_state(tm, [np.zeros(17)])
    with pytest.raises(ValueError, match="components"):
        treg.reshape_flat_state(ts, [np.zeros(4), np.zeros(4)])
    from spheremanopt_torch.problems.pca import PCAProblem

    p = PCAProblem(np.eye(6), device="cpu")
    assert treg.expected_state_shapes(p) is None
    assert np.array_equal(treg.reshape_flat_state(p, [np.ones(6)])[0], np.ones(6))
    with pytest.raises(ValueError, match="no rule"):
        treg.regrid_state(p, [np.ones(6)])


def test_kdyn_distributed_target(tmp_path):
    """A replicated fft-config state regridded onto a DISTRIBUTED target
    (slab over 2 ranks): the output is the same full (c, mg, mg, mg) grid
    layout as onto an fft target (the caller shards it), and the
    distributed objective at the regridded state matches the fft
    objective at the equally regridded state (JAX's
    `tests/test_regrid.py::test_kdyn_distributed_target`)."""
    import torch_dist_cases as cases
    from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    p = KinematicDynamo(KDynConfig(npts=8, n_iters=4, dtype="float64", transform="fft"))
    x = [np.asarray(a) for a in p.generate_ic(seed=3)]
    with cases.LocalWorld(2, str(tmp_path)) as w:
        outs = w.run(cases.regrid_distributed_target, x)
    xd, xm, Jd, Jm, mg = outs[0]
    for a, b in zip(xd, xm):
        assert a.shape == (3, mg, mg, mg)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)
    assert np.isclose(Jd, Jm, rtol=1e-10), (Jd, Jm)
    assert outs[1][2] == Jd
