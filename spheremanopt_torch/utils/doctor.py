"""Environment diagnostic: `python -m spheremanopt_torch.run doctor`.

A one-command health report of the port's environment, printed as JSON
with a one-line verdict: the Python, torch and CUDA versions, a CPU
probe, a GPU probe (the executing device, its name, SM count and opt-in
shared memory per block), the compilers of the two native builds (nvcc
for the CUDA kernels, g++ for the record writer), whether the kernels'
library is built for the current sources, and the build and operator
cache directories. Every check that can hang runs in a child process
with a timeout (the CPU and GPU probes side by side), so the doctor
itself never hangs. It imports no torch and initialises no CUDA in its
own process (the CPU probe reports torch's versions), and it builds
nothing: it reports whether the CUDA library and the record writer are
built.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

__all__ = ["run_doctor"]

# the GPU probe's value: a sum of 128 x 128 ones on the card
_GPU_VALUE = "16384.0"

# CPU path: a small f64 sum in torch; the child also prints torch's
# versions, so that this process never imports torch
_CPU_PROBE = ("import torch; "
              "v = float((torch.ones(64, dtype=torch.float64) ** 2).sum()); "
              "print('|'.join([torch.__version__, str(torch.version.cuda), str(v)]))")

# GPU path: a sum on the card; the child prints the device it ran on, so
# a CPU-only torch cannot pass for a healthy card
_GPU_PROBE = (
    "import torch; "
    "d = torch.device('cuda' if torch.cuda.is_available() else 'cpu'); "
    "x = torch.ones((128, 128), device=d).sum(); "
    "p = torch.cuda.get_device_properties(d) if d.type == 'cuda' else None; "
    "print('|'.join([x.device.type, p.name if p else 'none', "
    "str(p.multi_processor_count if p else 0), "
    "str(p.shared_memory_per_block_optin if p else 0), str(float(x))]))")


def _subprocess_probe(code: str, timeout_s: float) -> Dict[str, Any]:
    """Run `code` in a clean child; return {ok, seconds, out|err}."""
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True,
                             timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"ok": False, "seconds": round(time.perf_counter() - t0, 1),
                "err": f"timeout after {timeout_s:.0f}s"}
    d = {"ok": out.returncode == 0,
         "seconds": round(time.perf_counter() - t0, 1)}
    if out.returncode == 0:
        d["out"] = out.stdout.strip().splitlines()[-1] if out.stdout else ""
    else:
        d["err"] = (out.stderr or "").strip().splitlines()[-1:]
    return d


def _dir_stats(path: str) -> Dict[str, Any]:
    if not os.path.isdir(path):
        return {"present": False, "path": path}
    n, size = 0, 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            n += 1
            try:
                size += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return {"present": True, "path": path, "files": n,
            "mb": round(size / 1e6, 1)}


def _gpu_probe_ok(probe: Dict[str, Any]) -> bool:
    """True iff the GPU probe ran, on `cuda`, and computed the expected
    value. Probe output: '<device type>|<name>|<SMs>|<smem optin>|<value>'."""
    if not probe.get("ok"):
        return False
    parts = str(probe.get("out", "")).split("|")
    return len(parts) == 5 and parts[0] == "cuda" and parts[4] == _GPU_VALUE


def _gpu_fields(probe: Dict[str, Any]) -> Dict[str, Any]:
    parts = str(probe.get("out", "")).split("|")
    if len(parts) != 5:
        return {}
    return {"device_type": parts[0], "name": parts[1], "sms": int(parts[2]),
            "smem_optin_bytes": int(parts[3])}


def _kernel_library() -> Dict[str, Any]:
    """Whether the CUDA kernels' library for the current sources exists
    (its path hashes the sources; reading it builds nothing)."""
    from spheremanopt_torch.ops.cuda import build as kbuild

    lib = kbuild.library_path()
    built = sorted(p.parent.name for p in kbuild.BUILD_ROOT.glob(
        f"*/{lib.name}")) if kbuild.BUILD_ROOT.is_dir() else []
    return {"path": str(lib), "current": lib.exists(),
            "other_builds": [b for b in built if b != lib.parent.name]}


def _nvcc() -> Dict[str, Any]:
    from spheremanopt_torch.ops.cuda import build as kbuild

    try:
        return {"present": True, "path": kbuild.find_nvcc()}
    except RuntimeError:
        return {"present": False}


def run_doctor(probe_timeout_s: float | None = None,
               verbose: bool = True) -> dict:
    """Collect the health report; print it when verbose. Returns the
    report dict; `report["cpu_ok"]` gates the exit code (a missing or
    unreachable card is an environment state to report, not a failure
    of the installation). The GPU probe's deadline defaults to 90 s;
    override with SMO_DOCTOR_PROBE_S."""
    if probe_timeout_s is None:
        probe_timeout_s = float(os.environ.get("SMO_DOCTOR_PROBE_S", "90"))
    rep: Dict[str, Any] = {}

    rep["python"] = sys.version.split()[0]
    rep["env"] = {k: v for k, v in os.environ.items()
                  if k in ("CUDA_VISIBLE_DEVICES", "SMO_OP_CACHE",
                           "SMO_DOCTOR_PROBE_S")}
    # the two probes run side by side, each in a child
    with ThreadPoolExecutor(2) as pool:
        cpu = pool.submit(_subprocess_probe, _CPU_PROBE, 60)
        gpu = pool.submit(_subprocess_probe, _GPU_PROBE, probe_timeout_s)
        rep["cpu"], rep["gpu"] = cpu.result(), gpu.result()
    parts = str(rep["cpu"].get("out", "")).split("|") if rep["cpu"].get("ok") else []
    ran = len(parts) == 3
    rep["torch"] = parts[0] if ran else None
    rep["torch_cuda"] = parts[1] if ran and parts[1] != "None" else None
    rep["cpu_ok"] = ran and parts[2] == "64.0"
    rep["gpu_ok"] = _gpu_probe_ok(rep["gpu"])
    rep["gpu"].update(_gpu_fields(rep["gpu"]))

    rep["compilers"] = {"nvcc": _nvcc(), "g++": shutil.which("g++") is not None}
    rep["kernel_library"] = _kernel_library()

    from spheremanopt_torch.ops.cuda import build as kbuild
    from spheremanopt_torch.utils.opcache import _cache_dir

    rep["build_dir"] = _dir_stats(str(kbuild.BUILD_ROOT))
    od = _cache_dir()
    rep["op_cache"] = (_dir_stats(od) if od
                       else {"present": False, "disabled": "SMO_OP_CACHE=0"})

    # native record writer: g++ builds it on its first use, not here
    from spheremanopt_torch.io import native_io

    lib = native_io.library_path()
    rep["native_io"] = {"path": str(lib), "built": lib.exists(),
                        "available": lib.exists() or rep["compilers"]["g++"]}

    if verbose:
        print(json.dumps(rep, indent=2))
        verdict = ("OK (CPU + GPU healthy)" if rep["cpu_ok"] and rep["gpu_ok"]
                   else "DEGRADED (CPU ok; no usable CUDA GPU)"
                   if rep["cpu_ok"] else "BROKEN (CPU path failed)")
        print(f"doctor: {verdict}")
    return rep
