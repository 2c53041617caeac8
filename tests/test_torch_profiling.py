"""The port's profiling utilities (`spheremanopt_torch/utils/profiling.py`):
the four cost models equal the JAX package's for the same arguments,
`roofline` against the H100 peaks (the counterpart of
`tests/test_aux_io_cli.py::test_roofline_cost_models`), `bound_ms`
reproduces the bounds of the kernels line (PERF.md), `passes_for` knows
the port's modes only, `trace` writes a Chrome trace on the CPU and
`time_solve` returns (first call s, steady ms, result)."""

import json
import os

import pytest
import torch

from spheremanopt_torch.utils import profiling as prof
from spheremanopt_tpu.utils import profiling as jprof


@pytest.mark.parametrize("name, args, kw", [
    ("sh23_cost_model", (256, 1000), {}),
    ("sh23_cost_model", (128, 50), dict(pad=1.5, bytes_per=8, passes=3)),
    ("shb23_cost_model", (512, 2000), {}),
    ("shb23_cost_model", (64, 40), dict(bytes_per=8, passes=2)),
    ("kdyn_cost_model", (24, 2000), {}),
    ("kdyn_cost_model", (16, 9), dict(pad=2.0, bytes_per=8)),
    ("mixing_cost_model", (256, 128, 1000), {}),
    ("mixing_cost_model", (32, 16, 20), dict(blocked=False, bytes_per=8, passes=6)),
])
def test_cost_models_equal_jax(name, args, kw):
    assert getattr(prof, name)(*args, **kw) == getattr(jprof, name)(*args, **kw)


def test_matmul_step_flops_equal_jax():
    for a in ((512, 1000), (36, 200, 3, True)):
        assert prof.matmul_step_flops(*a) == jprof.matmul_step_flops(*a)


def test_roofline_cost_models():
    """Achieved rates scale inversely with time, the % of peak are
    consistent with the H100 peaks, and each model counts positive work."""
    f, b = prof.sh23_cost_model(256, 1000)
    assert f > 0 and b > 0
    r1 = prof.roofline(10.0, f, b)
    r2 = prof.roofline(20.0, f, b)
    assert abs(r1["achieved_hbm_gbps"] - 2 * r2["achieved_hbm_gbps"]) < 0.2
    assert r1["pct_peak_hbm"] == round(100.0 * (b / 1e-2) / prof.HBM_RATE, 1)
    assert r1["pct_peak_flops"] == round(100.0 * (f / 1e-2) / prof.F32_PEAK, 2)
    assert prof.roofline(10.0, f, b, peak=prof.TF32_PEAK)["pct_peak_flops"] < r1["pct_peak_flops"]
    assert "pct_peak_mxu" not in r1
    for fn, args in ((prof.shb23_cost_model, (512, 2000)),
                     (prof.kdyn_cost_model, (24, 2000)),
                     (prof.mixing_cost_model, (256, 128, 1000))):
        fl, by = fn(*args)
        assert fl > 0 and by > 0


def test_peaks_are_the_h100_sxm_data_sheet():
    assert (prof.F32_PEAK, prof.TF32_PEAK, prof.HBM_RATE) == (67e12, 495e12, 3.35e12)


# the bounds of the kernels line as PERF.md's kernel table prints them:
# (work model of chip_smoke.py, its arguments, the bound, its unit)
SECTION6_BOUNDS = [
    ("sweep_work", (512, 1000, 1), dict(fwd=True), "7.92", "us"),      # rows 1, 1v
    ("sweep_work", (512, 1000, 1), dict(fwd=False), "7.92", "us"),     # row 2
    ("sweep_work", (1024, 200, 1), dict(fwd=False), "6.3", "us"),      # rows 1b, 2b
    ("sweep_work", (512, 2000, 2), dict(fwd=True), "31.5", "us"),      # row 3
    ("sweep_work", (512, 2000, 2), dict(fwd=False), "31.5", "us"),     # row 4
    ("sweep_work", (1024, 200, 2), dict(fwd=True), "12.6", "us"),      # rows 3b, 4b
    ("sweep_work", (2048, 200, 2), dict(fwd=False), "50.2", "us"),     # rows 3c, 4c
    ("op_grads_work", (512, 2000, 2), {}, "12.7", "us"),               # product, SHB23
    ("op_grads_work", (512, 1000, 1), {}, "3.2", "us"),                # product, SH23
    ("kdyn_work", (24, 36, 2000), dict(fwd=True, traj=False), "1.426", "ms"),   # row 5
    ("kdyn_work", (24, 36, 2000), dict(fwd=True, traj=True), "1.426", "ms"),    # row 6
    ("kdyn_work", (24, 36, 2000), dict(fwd=False, traj=True), "2.139", "ms"),   # row 7
]


@pytest.mark.parametrize("model, args, kw, printed, unit", SECTION6_BOUNDS)
def test_bound_ms_reproduces_the_kernel_table(model, args, kw, printed, unit):
    """chip_smoke.py prints its bounds through `bound_ms`: the kernel
    table's bounds, all bound by operations, to the digits printed."""
    import chip_smoke

    assert chip_smoke.bound_ms is prof.bound_ms
    got, by = prof.bound_ms(*getattr(chip_smoke, model)(*args, **kw))
    decimals = len(printed.split(".")[1])
    assert f"{got * (1e3 if unit == 'us' else 1.0):.{decimals}f}" == printed
    assert by == "operations"


def test_bound_ms_takes_the_larger_time():
    ms, by = prof.bound_ms(1e9, 1e12)
    assert ms == pytest.approx(1e3 * 1e12 / prof.HBM_RATE) and by == "bytes"
    ms, by = prof.bound_ms(1e12, 1e6, prof.TF32_PEAK)
    assert ms == pytest.approx(1e3 * 1e12 / prof.TF32_PEAK) and by == "operations"


def test_passes_for_port_modes_only():
    assert [prof.passes_for(m) for m in ("float32", "float64", "3xtf32")] == [1, 1, 3]
    for tpu_mode in ("compensated", "high", "highest", "bfloat16"):
        with pytest.raises(ValueError, match="no port mode"):
            prof.passes_for(tpu_mode)


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with prof.trace(str(d)) as p:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(d, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert len(p.key_averages()) > 0


def test_time_solve_shape():
    calls = []

    def fn(a):
        calls.append(1)
        return [a * 2.0, {"x": a}]

    first, steady, r = prof.time_solve(fn, torch.ones(3), repeats=4)
    assert first >= 0.0 and steady >= 0.0 and len(calls) == 5
    assert torch.equal(r[0], torch.full((3,), 2.0))
