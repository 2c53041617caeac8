"""`spheremanopt_torch.run doctor`: the port's environment report, the
counterparts of `tests/test_doctor.py`. On a machine without a CUDA GPU
it reports `gpu_ok: false` and exits 0 (the exit code follows the CPU
path); a GPU probe that ran on the CPU never reads as a healthy card."""

import json
import os
import subprocess
import sys

from spheremanopt_torch.utils.doctor import _gpu_probe_ok, run_doctor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_report_shape_and_cpu_health():
    rep = run_doctor(probe_timeout_s=60.0, verbose=False)
    assert rep["cpu_ok"] is True, rep["cpu"]
    for key in ("python", "torch", "torch_cuda", "cpu", "gpu", "gpu_ok", "compilers",
                "kernel_library", "build_dir", "op_cache", "native_io"):
        assert key in rep, key
    assert isinstance(rep["gpu_ok"], bool)
    assert rep["compilers"]["g++"] is True
    assert set(rep["kernel_library"]) >= {"path", "current"}
    if not rep["gpu_ok"]:
        assert rep["gpu"].get("device_type") in (None, "cpu")


def test_cli_doctor_exits_zero_and_emits_json():
    out = subprocess.run(
        [sys.executable, "-m", "spheremanopt_torch.run", "doctor"],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, SMO_DOCTOR_PROBE_S="60"))
    assert out.returncode == 0, out.stderr
    body = out.stdout[out.stdout.index("{"):out.stdout.rindex("}") + 1]
    rep = json.loads(body)
    assert rep["cpu_ok"] is True
    assert "doctor:" in out.stdout
    import torch

    assert rep["gpu_ok"] is torch.cuda.is_available()


def test_gpu_probe_rejects_cpu_fallback():
    """A probe that ran on the CPU (value still 16384.0), an empty device
    type and a failed probe never report the GPU healthy."""
    ok = "cuda|NVIDIA H100 80GB HBM3|132|232448|16384.0"
    assert _gpu_probe_ok({"ok": True, "out": ok})
    assert not _gpu_probe_ok({"ok": True, "out": "cpu|none|0|0|16384.0"})
    assert not _gpu_probe_ok({"ok": True, "out": "|none|0|0|16384.0"})
    assert not _gpu_probe_ok({"ok": True, "out": "16384.0"})
    assert not _gpu_probe_ok({"ok": False, "out": ok})
    assert not _gpu_probe_ok({"ok": True, "out": ok.replace("16384.0", "0.0")})
