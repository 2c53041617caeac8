"""The port's optimisation server (`spheremanopt_torch/serve.py`) on the
CPU: the JAX service's protocol, loop-cache reuse, sweep batching,
persistence and the socket transport, one counterpart for each test of
`tests/test_serve.py`; and the same sh23 `optimise` and `sweep` requests
sent to the JAX package's `OptimisationService` and to the port's, from
the same initial conditions, with J within rtol 1e-9 and equal
iteration counts."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from spheremanopt_torch.serve import OptimisationService, request, serve


@pytest.fixture(scope="module")
def svc():
    return OptimisationService(device="cpu")


@pytest.fixture
def one_thread():
    """Long loops of small products: one intra-op thread, so several test
    workers on one host do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SH23_CFG = {"npts": 64, "n_iters": 50, "dt": 0.05, "e0": 0.0725}
DRIVER = {"max_iters": 5, "line_search": "wolfe", "cg": True}
PCA_REQ = {"cmd": "optimise", "problem": "pca",
           "config": {"dim": 24, "matrix_seed": 0}, "seed": 1,
           "driver": {"max_iters": 12, "cg": True}}


def _serving(tmp_path):
    """A server thread on a socket in `tmp_path` (a CPU service)."""
    sock = str(tmp_path / "smo.sock")
    ready = threading.Event()
    t = threading.Thread(target=serve, args=(sock,),
                         kwargs={"ready_event": ready, "device": "cpu"},
                         daemon=True)
    t.start()
    assert ready.wait(10)
    return sock, t


def test_status(svc):
    out = svc.handle({"cmd": "status"})
    assert out["ok"] and out["requests"] == 1 and out["executables"] == []
    assert out["busy"] is None and out["queued"] == 0


def test_optimise_pca_and_cache_reuse(svc):
    a = svc.handle(PCA_REQ)
    assert a["ok"], a
    assert not a["cache_hit"]
    assert a["iterations"] >= 1
    # maximisation: -J_k (reference convention) is non-decreasing
    J = a["J"]
    assert all(x <= y + 1e-12 for x, y in zip(J, J[1:])), J
    b = svc.handle(dict(PCA_REQ, seed=2))
    assert b["ok"] and b["cache_hit"]
    st = svc.handle({"cmd": "status"})
    assert len(st["executables"]) == 1


def test_optimise_lbfgs_driver_passthrough(svc):
    """The driver dict forwards into jit_optimise_on_multi_sphere, so the
    L-BFGS direction is servable with no protocol change."""
    out = svc.handle(dict(PCA_REQ, driver={"max_iters": 12, "line_search": "wolfe",
                                           "direction": "lbfgs"}))
    assert out["ok"], out
    J = out["J"]
    assert all(x <= y + 1e-12 for x, y in zip(J, J[1:])), J


def test_optimise_matches_direct_driver_call(svc, one_thread):
    out = svc.handle({"cmd": "optimise", "problem": "sh23",
                      "config": SH23_CFG, "driver": DRIVER, "seed": 3})
    assert out["ok"], out

    from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
    from spheremanopt_torch.problems.swift_hohenberg import (
        SH23Config, SwiftHohenberg)

    p = SwiftHohenberg(SH23Config(**SH23_CFG), device="cpu")
    opt = jit_optimise_on_multi_sphere(p.objective_and_gradient,
                                       p.inner_product, p.radii, **DRIVER)
    res = opt(p.generate_ic(seed=3))
    n = int(res.iterations)
    assert out["iterations"] == n
    np.testing.assert_array_equal(out["J"], res.function_values.numpy()[:n])


def test_sweep_rows_match_individual_optimise(svc, one_thread):
    sweep = svc.handle({"cmd": "sweep", "problem": "sh23",
                        "config": SH23_CFG, "driver": DRIVER,
                        "seeds": [3, 5], "e0": [0.0725, 0.05]})
    assert sweep["ok"], sweep
    assert len(sweep["points"]) == 2
    assert [r["seed"] for r in sweep["points"]] == [3, 5]
    assert [r["e0"] for r in sweep["points"]] == [0.0725, 0.05]
    # the first sweep point (e0 = config default) equals the plain
    # optimise, row for row (native matmul rows: to reduction order)
    single = svc.handle({"cmd": "optimise", "problem": "sh23",
                         "config": SH23_CFG, "driver": DRIVER, "seed": 3})
    row = sweep["points"][0]
    assert row["iterations"] == single["iterations"]
    np.testing.assert_allclose(row["J"], single["J"], rtol=1e-10)
    # distinct radii -> genuinely different trajectories
    assert sweep["points"][1]["J"] != row["J"]


def test_sweep_mixing_aux_operand_path(svc, one_thread, monkeypatch, tmp_path):
    """The mixing sweep takes the operator stacks as the loop's aux
    operand, one object for every row (native rows). Rows match plain
    optimise."""
    monkeypatch.setenv("SMO_OP_CACHE", str(tmp_path))
    cfg = {"nx": 32, "nz": 24, "n_iters": 30, "dt": 5e-3, "s": 1}
    driver = {"max_iters": 3, "line_search": "wolfe", "cg": True}
    sweep = svc.handle({"cmd": "sweep", "problem": "mixing",
                        "config": cfg, "driver": driver, "seeds": [3, 5]})
    assert sweep["ok"], sweep
    assert len(sweep["points"]) == 2
    single = svc.handle({"cmd": "optimise", "problem": "mixing",
                         "config": cfg, "driver": driver, "seed": 3})
    assert single["ok"], single
    row = sweep["points"][0]
    assert row["iterations"] == single["iterations"]
    np.testing.assert_allclose(row["J"], single["J"], rtol=1e-10)


def test_sweep_executable_is_cached(svc, one_thread):
    req = {"cmd": "sweep", "problem": "sh23", "config": SH23_CFG,
           "driver": DRIVER, "seeds": [3, 5], "e0": [0.0725, 0.05]}
    svc.handle(req)
    before = svc.handle({"cmd": "status"})["cache_hits"]
    out = svc.handle(req)
    assert out["ok"] and out["cache_hit"]
    after = svc.handle({"cmd": "status"})["cache_hits"]
    # optimiser-cache hit + sweep-loop hit on the repeat call
    assert after >= before + 2
    keys = svc.handle({"cmd": "status"})["executables"]
    assert any('"kind": "sweep"' in k and '"batch": 2' in k for k in keys)


def test_save_persists_result(svc, tmp_path):
    path = str(tmp_path / "serve_out.npz")
    out = svc.handle(dict(PCA_REQ, save=path))
    assert out["ok"] and out["saved"] == path
    dat = np.load(path)
    assert sorted(dat.files) == ["function_values", "iterations", "residuals",
                                 "step_sizes", "x_opt_0"]
    assert dat["x_opt_0"].shape == (24,)
    assert int(dat["iterations"]) == out["iterations"]


def test_errors_are_replies_not_crashes(svc):
    out = svc.handle({"cmd": "optimise", "problem": "nope"})
    assert not out["ok"] and "unknown problem" in out["error"]
    out = svc.handle({"cmd": "optimise", "problem": "sh23",
                      "config": {"bogus_key": 1}})
    assert not out["ok"]
    out = svc.handle({"cmd": "sweep", "problem": "sh23", "config": SH23_CFG,
                      "seeds": [1, 2], "e0": [0.05]})
    assert not out["ok"] and "e0 must match seeds length" in out["error"]
    out = svc.handle({"cmd": "frobnicate"})
    assert not out["ok"] and "unknown cmd" in out["error"]
    # service must still be alive
    assert svc.handle({"cmd": "status"})["ok"]


def test_socket_transport_round_trip(tmp_path):
    sock, t = _serving(tmp_path)
    st = request(sock, {"cmd": "status"})
    assert st["ok"] and st["executables"] == []
    out = request(sock, {"cmd": "optimise", "problem": "pca",
                         "config": {"dim": 16, "matrix_seed": 0},
                         "seed": 7, "driver": {"max_iters": 8}})
    assert out["ok"] and out["iterations"] >= 1
    bad = request(sock, {"cmd": "optimise", "problem": "nope"})
    assert not bad["ok"]
    bye = request(sock, {"cmd": "shutdown"})
    assert bye["ok"]
    t.join(10)
    assert not t.is_alive()
    assert not os.path.exists(sock)


def test_concurrent_clients_status_during_long_compute(tmp_path, one_thread):
    """A status request is answered at once while a long compute runs
    (threaded accept), the occupancy is visible ('busy'/'queued'), and a
    second compute queues FIFO without corruption."""
    sock, t = _serving(tmp_path)
    slow = {"cmd": "optimise", "problem": "sh23",
            "config": {"npts": 64, "n_iters": 200, "dt": 0.05},
            "seed": 1, "driver": {"max_iters": 8, "line_search": "wolfe"}}
    done = {}

    def long_call(key, req):
        done[key] = request(sock, req, timeout=300.0)

    t1 = threading.Thread(target=long_call, args=("a", slow), daemon=True)
    t1.start()
    t2 = threading.Thread(target=long_call, args=("b", dict(slow, seed=2)),
                          daemon=True)
    t2.start()

    saw_busy = False
    deadline = time.time() + 120
    while (t1.is_alive() or t2.is_alive()) and time.time() < deadline:
        t0 = time.time()
        st = request(sock, {"cmd": "status"}, timeout=30.0)
        assert st["ok"]
        assert "busy" in st and "queued" in st
        if st["busy"] is not None or st["queued"] > 0:
            saw_busy = True
            # the threaded accept answers without waiting for the worker
            assert time.time() - t0 < 5.0
        time.sleep(0.02)
    t1.join(120)
    t2.join(120)
    assert done["a"]["ok"] and done["b"]["ok"], done
    assert saw_busy, "status never observed the busy/queued occupancy"
    assert done["a"]["iterations"] >= 1 and done["b"]["iterations"] >= 1
    assert done["a"]["J"] != done["b"]["J"]  # different seeds
    request(sock, {"cmd": "shutdown"})
    t.join(10)


def test_cuda_service_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU found"):
        OptimisationService()
    with pytest.raises(SystemExit, match="no CUDA GPU found"):
        from spheremanopt_torch.serve import main

        main(["--socket", "/nonexistent/smo.sock"])


def test_same_requests_as_the_jax_service(monkeypatch, one_thread):
    """sh23 `optimise` and `sweep` requests through both services from the
    same initial conditions (the port's problem draws the JAX package's,
    since torch and JAX draw other numbers from one seed): J within rtol
    1e-9, equal iteration counts."""
    from spheremanopt_torch.problems.swift_hohenberg import SwiftHohenberg
    from spheremanopt_tpu.problems.swift_hohenberg import (
        SH23Config as JConfig, SwiftHohenberg as JSH)
    from spheremanopt_tpu.serve import OptimisationService as JService

    jp = JSH(JConfig(**SH23_CFG))

    def jax_ic(self, seed=42, e0=None, noise=None):
        x = np.array(jp.generate_ic(seed=seed, e0=e0)[0])
        return [torch.as_tensor(x, device=self.device)]

    monkeypatch.setattr(SwiftHohenberg, "generate_ic", jax_ic)
    mine, theirs = OptimisationService(device="cpu"), JService()
    reqs = [{"cmd": "optimise", "problem": "sh23", "config": SH23_CFG,
             "driver": DRIVER, "seed": 3},
            {"cmd": "sweep", "problem": "sh23", "config": SH23_CFG,
             "driver": DRIVER, "seeds": [3, 5, 7], "e0": [0.0725, 0.05, 0.1]}]
    for req in reqs:
        a, b = mine.handle(req), theirs.handle(req)
        assert a["ok"] and b["ok"], (a, b)
        rows_a = a.get("points", [a])
        rows_b = b.get("points", [b])
        assert len(rows_a) == len(rows_b)
        for ra, rb in zip(rows_a, rows_b):
            assert ra["iterations"] == rb["iterations"]
            np.testing.assert_allclose(ra["J"], rb["J"], rtol=1e-9)
            np.testing.assert_allclose(ra["step_sizes"], rb["step_sizes"], rtol=1e-9)
