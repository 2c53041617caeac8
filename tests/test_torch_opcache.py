"""The port's on-disk operator cache (`spheremanopt_torch/utils/opcache.py`):
the mixing tau assembly is served from a content-keyed npz after its first
build, keyed apart from the JAX package's entries."""

import glob
import os

import numpy as np
import pytest

from spheremanopt_torch.problems import optimal_mixing as om
from spheremanopt_torch.utils import opcache

CFG = dict(nx=8, nz=8, n_iters=2, prep_steps=2, dtype="float64")


def _files(d):
    return sorted(glob.glob(os.path.join(d, "ops_*.npz")))


def _mix(**kw):
    return om.OptimalMixing(om.MixingConfig(**{**CFG, **kw}), device="cpu")


def test_cache_roundtrip_and_sabotaged_rebuild(tmp_path, monkeypatch):
    monkeypatch.setenv("SMO_OP_CACHE", str(tmp_path))
    p1 = _mix()
    assert len(_files(str(tmp_path))) == 1   # one entry: (S, MN) together
    monkeypatch.setattr(
        om.OptimalMixing, "_build_operators_uncached",
        lambda self, *a, **k: (_ for _ in ()).throw(
            AssertionError("builder called despite a warm cache")))
    p2 = _mix()
    np.testing.assert_array_equal(p1._S_np, p2._S_np)
    np.testing.assert_array_equal(p1._MN_np, p2._MN_np)
    assert p2._S_np.dtype == np.complex128   # exact f64 bits preserved


@pytest.mark.parametrize("change", [dict(reynolds=250.0), dict(dt=1e-3),
                                    dict(richardson=0.1), dict(nz=10)])
def test_cache_key_sensitivity(change, tmp_path, monkeypatch):
    monkeypatch.setenv("SMO_OP_CACHE", str(tmp_path))
    _mix()
    _mix(**change)
    assert len(_files(str(tmp_path))) == 2   # the knob changes the key
    # dtype, n_iters and s do not enter the stacks: served from the cache
    _mix(dtype="float32", n_iters=5, s=0)
    assert len(_files(str(tmp_path))) == 2


def test_cache_keys_the_adjoint_and_mixnorm_flags(tmp_path, monkeypatch):
    monkeypatch.setenv("SMO_OP_CACHE", str(tmp_path))
    p = _mix(adjoint="continuous")            # (S, MN) and (SA, None)
    assert len(_files(str(tmp_path))) == 2
    S1, MN1 = p._build_operators(dt=p.cfg.prep_dt, build_mixnorm=False)
    assert MN1 is None and len(_files(str(tmp_path))) == 3
    S2, MN2 = p._build_operators(dt=p.cfg.prep_dt, build_mixnorm=False)
    assert MN2 is None
    np.testing.assert_array_equal(S1, S2)
    SA, none = p._build_operators(adjoint=True, build_mixnorm=False)
    assert none is None and not np.array_equal(SA, p._S_np)
    assert len(_files(str(tmp_path))) == 3


def test_cache_disabled(monkeypatch):
    monkeypatch.setenv("SMO_OP_CACHE", "0")
    assert opcache._cache_dir() is None
    calls = []

    def builder():
        calls.append(1)
        return (np.ones(3), None)

    for _ in range(2):   # every call rebuilds: nothing is persisted
        S, MN = opcache.cached_arrays({"k": 1}, builder, ("S", "MN"))
        assert MN is None
    assert len(calls) == 2


def test_default_dir_is_in_the_checkout(monkeypatch):
    monkeypatch.delenv("SMO_OP_CACHE", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert opcache._cache_dir() == os.path.join(root, "build", "op_cache")
    monkeypatch.setenv("SMO_OP_CACHE", "1")
    assert opcache._cache_dir() == os.path.join(root, "build", "op_cache")


def test_corrupt_entry_rebuilds(tmp_path, monkeypatch):
    monkeypatch.setenv("SMO_OP_CACHE", str(tmp_path))
    p1 = _mix()
    with open(_files(str(tmp_path))[0], "wb") as fh:
        fh.write(b"torn")
    p2 = _mix()   # must rebuild, not crash
    np.testing.assert_array_equal(p1._S_np, p2._S_np)
    with np.load(_files(str(tmp_path))[0]) as z:   # and rewrite the entry
        np.testing.assert_array_equal(z["S"], p1._S_np)


def test_never_serves_the_jax_packages_entries(tmp_path, monkeypatch):
    """The two packages share SMO_OP_CACHE but not their keys: each builds
    its own entry in one directory, and the stacks agree bitwise."""
    from spheremanopt_tpu.problems.optimal_mixing import MixingConfig, OptimalMixing

    monkeypatch.setenv("SMO_OP_CACHE", str(tmp_path))
    j = OptimalMixing(MixingConfig(**CFG, device_ops=False))
    assert len(_files(str(tmp_path))) == 1
    t = _mix()
    assert len(_files(str(tmp_path))) == 2
    np.testing.assert_array_equal(t._S_np, j._S_np)
    assert om._OP_BUILDER_DIGEST == opcache.source_digest(
        om.OptimalMixing._build_operators_uncached, om._cheb_mult_T,
        om._block_solve, om.ChebyshevBasis1D)
