"""Time the fused reverse-sweep kernels of one checkout of the PyTorch port
on one NVIDIA GPU, for comparing two checkouts in turns on one card.

    python tools/time_reverse_sweeps.py [--root DIR] [--tag NAME]

`--root` is the checkout whose `spheremanopt_torch` is imported (default:
this one); its kernels are built there at first use. At the SH23 width
(B = M of `SH23Config()`, mg = 512, N = 1000) and the SHB23 width (A, B of
`SHB23Config()`, mg = 512, N = 2000) it times, by CUDA events over 20
calls after 2 warm-up calls, the reverse sweep without the lambda history
(`fused_bwd_shared`, `fused_bwd`) and, where the checkout has it, with
the history (`lam_hist=`), and prints one JSON line with the card's name
and power limit. Run parent, change, change, parent, each in its own
process, and compare within one call only.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def gpu_ms(fn, reps=20, warm=2):
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_reverse_sweeps: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from spheremanopt_torch.ops.cuda import fused_two_matrix as fk
    from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg
    from spheremanopt_torch.problems.swift_hohenberg_bounded import (
        SHB23Config, SwiftHohenbergBounded)

    dev = torch.device("cuda")
    has_hist = "lam_hist" in inspect.signature(fk.fused_bwd_shared).parameters
    out = {"tag": args.tag, "root": os.path.abspath(args.root), "card": card_line()}

    p = SwiftHohenberg(SH23Config(dtype="float32", method="cuda"), device=dev)
    mg, n, lin = p.basis.n_grid, p.cfg.n_iters, 1.0 / p.cfg.dt
    b = p._Mt.float().contiguous()
    w = torch.full((mg,), 1.0 / mg, device=dev)
    x = torch.as_tensor(np.random.RandomState(1).randn(mg), dtype=torch.float32, device=dev)
    u0 = torch.mv(p._Pt.float(), x) * 0.3
    uT, _, tr, _ = fk.fused_fwd_shared(b, w, u0, 1.8, -1.0, lin, n)
    sc = torch.tensor(-2.0 * p.cfg.dt, device=dev)
    out["sh23_bwd_ms"] = gpu_ms(lambda: fk.fused_bwd_shared(b, w, uT, tr, 1.8, -1.0, lin, sc, n))
    if has_hist:
        hist = torch.empty_like(tr)
        out["sh23_bwd_hist_ms"] = gpu_ms(lambda: fk.fused_bwd_shared(
            b, w, uT, tr, 1.8, -1.0, lin, sc, n, lam_hist=hist))

    q = SwiftHohenbergBounded(SHB23Config(dtype="float32", method="cuda"), device=dev)
    a2, b2 = q._Alt.float().contiguous(), q._Ant.float().contiguous()
    w2, n2 = q._wt.float().contiguous(), q.cfg.n_iters
    u2 = torch.as_tensor(np.random.RandomState(2).randn(a2.shape[0]), dtype=torch.float32,
                         device=dev)
    u2 = u2 * torch.sqrt(q.cfg.m0 / torch.sum(w2 * u2 * u2))
    uT2, _, tr2, _ = fk.fused_fwd(a2, b2, w2, u2, 2.0, -1.0, n2)
    sc2 = torch.tensor(-2.0 * q.cfg.dt, device=dev)
    out["shb23_bwd_ms"] = gpu_ms(lambda: fk.fused_bwd(a2, b2, w2, uT2, tr2, 2.0, -1.0, sc2, n2))
    if has_hist:
        hist2 = torch.empty_like(tr2)
        out["shb23_bwd_hist_ms"] = gpu_ms(lambda: fk.fused_bwd(
            a2, b2, w2, uT2, tr2, 2.0, -1.0, sc2, n2, lam_hist=hist2))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
