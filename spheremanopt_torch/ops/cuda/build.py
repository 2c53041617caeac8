"""Build the port's CUDA kernels at first use and load them with ctypes.

`spheremanopt_torch/csrc/*.cu` expose a plain C interface (pointers and
the stream as `void*`, scalars by value, a `cudaError_t` as `int`
return), so they compile with `nvcc` alone in seconds — no PyTorch
headers — for Hopper (`sm_90a`). Each source compiles to an object in
its own `nvcc` process, all started together, and one more `nvcc` links
them into one shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o <src>.o csrc/<src>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> *.o

The library goes to `build/spheremanopt_torch/<hash of the sources,
headers and flags>/` beside the package (git-ignored), so a changed
source rebuilds and an unchanged one is reused. There is no fallback: a
missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "spheremanopt_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_P, _F, _I, _L = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                  ctypes.c_longlong)
# C signatures of the exported functions (csrc/fused_shared.cu,
# csrc/fused_two_matrix.cu, csrc/op_grads.cu, csrc/kdyn_step.cu; those of
# csrc/fused_rows_g*.cu are reached through fused_two_matrix.cu's row
# launchers); the last argument of each launcher is the stream
_FWD = [_P, _P, _P, _P, _F, _F, _I, _I, _P, _P, _P, _P, _P]
_BWD = [_P, _P, _P, _P, _P, _F, _F, _P, _I, _I, _P, _P, _P]
_FWD_SHARED = [_P, _P, _P, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P]
_BWD_SHARED = [_P, _P, _P, _P, _F, _F, _F, _P, _I, _I, _P, _P, _P]
_KDYN_FWD = [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P]
SIGNATURES = {
    "sm_fused_fwd_shared_block": _FWD_SHARED,
    "sm_fused_bwd_shared": _BWD_SHARED,
    "sm_fused_bwd_shared_block": _BWD_SHARED,
    "sm_fused_bwd_shared_capacity": [_I, _I],  # returns a count, not an error code
    "sm_fused_bwd_shared_grid": [_P, _P, _P, _P, _F, _F, _F, _P, _I, _I, _I, _P, _P, _P, _P],
    "sm_fused_bwd_shared_grid_capacity": [_I, _I, _I],  # returns a count, not an error code
    "sm_fused_fwd_block": _FWD,
    "sm_fused_fwd_grid": [_P, _P, _P, _P, _F, _F, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "sm_fused_fwd_grid_capacity": [_I, _I, _I, _I],  # returns a count, not an error code
    "sm_fused_fwd_shared_grid": [_P, _P, _P, _F, _F, _F, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "sm_fused_fwd_shared_grid_capacity": [_I, _I, _I],  # returns a count, not an error code
    "sm_smem_optin": [],  # returns a size, not an error code
    "sm_fused_bwd": _BWD,
    "sm_fused_bwd_block": _BWD,
    "sm_fused_bwd_capacity": [_I, _I],  # returns a count, not an error code
    "sm_fused_bwd_grid": [_P, _P, _P, _P, _P, _P, _F, _F, _P, _I, _I, _I, _I, _P, _P, _P,
                          _P],
    "sm_fused_bwd_grid_capacity": [_I, _I, _I, _I],  # returns a count, not an error code
    "sm_fused_fwd_shared_rows": [_P, _P, _P, _F, _F, _F, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "sm_fused_fwd_shared_rows_capacity": [_I, _I, _I],  # returns a count, not an error code
    "sm_fused_bwd_shared_rows": [_P, _P, _P, _P, _F, _F, _F, _P, _I, _I, _I, _P, _P],
    "sm_fused_fwd_rows": [_P, _P, _P, _P, _F, _F] + [_I] * 6 + [_P] * 5,
    "sm_fused_fwd_rows_capacity": [_I, _I, _I],  # returns a count, not an error code
    "sm_fused_bwd_rows": [_P, _P, _P, _P, _P, _F, _F, _P, _I, _I, _I, _I, _P, _P],
    "sm_fused_bwd_rows_capacity": [_I, _I],  # returns a count, not an error code
    "sm_op_grads": [_P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _P, _P, _P],
    "sm_kdyn_work_floats": [_I, _I],   # returns a count, not an error code
    "sm_kdyn_row_group": [_I],         # returns a count, not an error code
    "sm_kdyn_fwd": _KDYN_FWD + [_P, _L, _P],
    "sm_kdyn_fwd_traj": _KDYN_FWD + [_P, _P, _P, _L, _P],
    "sm_kdyn_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P,
                    _P, _L, _P],
    "sm_kdyn_fwd_rows": _KDYN_FWD[:9] + [_I, _P, _P, _P, _P, _L, _P],
    "sm_kdyn_fwd_traj_rows": _KDYN_FWD[:9] + [_I, _P, _P, _P, _P, _P, _P, _L, _P],
    "sm_kdyn_bwd_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P, _P,
                         _P, _P, _L, _P],
}

CUDA_NVCC = "/usr/local/cuda/bin/nvcc"   # used when nvcc is not on PATH

_lib = None
# nvcc's output (ptxas register/shared-memory report) of the last library
# built or reused, kept beside each library as nvcc.log
build_log = ""


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or CUDA_NVCC
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (needed to build the CUDA kernels "
                           "in spheremanopt_torch/csrc)")
    return nvcc


def _sources(sources=None):
    """csrc/*.cu, or the named ones of them."""
    return sorted(CSRC / s for s in sources) if sources else sorted(CSRC.glob("*.cu"))


def library_path(flags=(), sources=None) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + list(flags)).encode())
    for src in _sources(sources) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libspheremanopt_kernels.so"


def _run_all(cmds):
    """Start every command at once; (return codes, combined output, each
    command's seconds)."""
    start = time.monotonic()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, secs = [None] * len(procs), [0.0] * len(procs)

    def wait(i):
        outs[i] = procs[i].communicate()[0]
        secs[i] = time.monotonic() - start

    threads = [threading.Thread(target=wait, args=(i,)) for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [p.returncode for p in procs], "".join(outs), secs


def build(flags=(), sources=None) -> Path:
    """Compile csrc/*.cu unless the library for these sources exists.
    `flags` adds nvcc flags and `sources` names the sources to take (the
    probe builds of tools/probe_kdyn_tasks.py), each in a library of its
    own."""
    global build_log
    lib = library_path(flags, sources)
    log = lib.parent / "nvcc.log"
    if lib.exists():
        build_log = log.read_text() if log.exists() else ""
        return lib
    nvcc = find_nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    srcs = _sources(sources)
    # build into a temporary directory and rename the library: concurrent
    # first uses never load a half-written one
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [os.path.join(tmp, s.stem + ".o") for s in srcs]
        codes, build_log, secs = _run_all(
            [[nvcc, *NVCC_FLAGS, *flags, "-c", "-o", o, str(s)]
             for s, o in zip(srcs, objs)])
        build_log += "".join(f"nvcc {s.name}: {t:.1f} s\n" for s, t in zip(srcs, secs))
        if any(codes):
            raise RuntimeError(f"nvcc failed ({codes}):\n{build_log}")
        out = os.path.join(tmp, lib.name)
        codes, link_log, _ = _run_all([[nvcc, *ARCH, "-shared", "-o", out, *objs]])
        build_log += link_log
        if any(codes):
            raise RuntimeError(f"nvcc link failed ({codes}):\n{build_log}")
        log.write_text(build_log)   # before the library: whoever finds one finds both
        os.replace(out, lib)
    return lib


def ptxas_report(log=None):
    """(kernel, registers, spill store bytes, spill load bytes) of each
    kernel instance in an nvcc -Xptxas -v log (default: `build_log`)."""
    out, name, spill = [], None, (None, None)
    for line in (build_log if log is None else log).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (None, None)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1))) + spill)
            name = None
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use, with typed signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
