"""Time the row kernels (a sweep's R rows in one launch) on one GPU.

    python tools/time_row_kernels.py [--rows 1,8] [--splits 4,8,16,32]

At full width (SH23: mg 512, N 1000; SHB23: mg 512, N 2000), by CUDA
events: each row forward at R rows with each split of B's rows over the
CTAs (`--splits`: rows of B a CTA; the wrappers' `rows_partition`),
every row of each split bitwise the wrapper's; the row reverses; and R
calls of the one-row kernels beside them. Prints one line a measurement
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spheremanopt_torch.ops.cuda import fused_two_matrix as fk  # noqa: E402
from spheremanopt_torch.ops.cuda.build import load  # noqa: E402
from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg  # noqa: E402
from spheremanopt_torch.problems.swift_hohenberg_bounded import (  # noqa: E402
    SHB23Config,
    SwiftHohenbergBounded,
)
from spheremanopt_torch.utils.profiling import card_name, gpu_ms  # noqa: E402


def forward_at_split(two_matrix, mats, w, u0, c, n, rows):
    """The row forward launched directly with `rows` rows of the operators
    a CTA: (uT, J, traj)."""
    R, mg = u0.shape
    uT, J = torch.empty_like(u0), torch.empty(R, device=u0.device)
    traj = torch.empty((R, n, mg), device=u0.device)
    slots = torch.empty(4 * R * mg, device=u0.device)
    lib = load()
    st = torch.cuda.current_stream().cuda_stream
    ptrs = [m.data_ptr() for m in mats] + [w.data_ptr(), u0.data_ptr()]
    if two_matrix:
        code = lib.sm_fused_fwd_rows(*ptrs, c[0], c[1], n, mg, rows, R, uT.data_ptr(),
                                     J.data_ptr(), traj.data_ptr(), slots.data_ptr(), st)
    else:
        code = lib.sm_fused_fwd_shared_rows(*ptrs, c[0], c[1], c[2], n, mg, rows, R,
                                            uT.data_ptr(), J.data_ptr(), traj.data_ptr(),
                                            slots.data_ptr(), st)
    if code != 0:
        raise RuntimeError(f"launch at {rows} rows a CTA failed: cudaError_t {code}")
    return uT, J, traj


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="1,8", help="row counts R")
    ap.add_argument("--splits", default="4,8,16,32", help="rows of B a CTA")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    name = card_name()
    p = SwiftHohenberg(SH23Config(dtype="float32", method="cuda"), device=dev)
    q = SwiftHohenbergBounded(SHB23Config(dtype="float32", method="cuda"), device=dev)
    mg = p.basis.n_grid
    cases = {
        "sh23": (False, (p._Mt.float().contiguous(),), torch.full((mg,), 1.0 / mg, device=dev),
                 (1.8, -1.0, 1.0 / p.cfg.dt), p.cfg.n_iters, -2.0 * p.cfg.dt),
        "shb23": (True, (q._Alt.float().contiguous(), q._Ant.float().contiguous()),
                  q._wt.float().contiguous(), (2.0, -1.0), q.cfg.n_iters, -2.0 * q.cfg.dt),
    }
    for tag, (two, mats, w, c, n, s0) in cases.items():
        prob = q if two else p
        for R in (int(v) for v in args.rows.split(",")):
            x = torch.stack([prob.generate_ic(seed=s)[0] for s in range(R)]).float()
            u0 = (x if two else torch.matmul(x, p._Pt.float().t())).contiguous()
            sc = s0 * torch.linspace(0.5, 1.5, R, device=dev)
            if two:
                fr = lambda u: fk.fused_fwd_rows(*mats, w, u, *c, n)   # noqa: E731
                br = lambda a, t: fk.fused_bwd_rows(*mats, w, a, t, *c, sc, n)  # noqa: E731
                f1 = lambda u: fk.fused_fwd(*mats, w, u, *c, n)   # noqa: E731
                b1 = lambda a, t, s: fk.fused_bwd(*mats, w, a, t, *c, s, n)  # noqa: E731
            else:
                fr = lambda u: fk.fused_fwd_shared_rows(*mats, w, u, *c, n)  # noqa: E731
                br = lambda a, t: fk.fused_bwd_shared_rows(  # noqa: E731
                    *mats, w, a, t, c[0], c[1], c[2], sc, n)
                f1 = lambda u: fk.fused_fwd_shared(*mats, w, u, *c, n)  # noqa: E731
                b1 = lambda a, t, s: fk.fused_bwd_shared(  # noqa: E731
                    *mats, w, a, t, c[0], c[1], c[2], s, n)
            uT, J, traj = fr(u0)
            torch.cuda.synchronize()
            default = fk.rows_partition(mg)[0]
            for rows in [default] + [int(v) for v in args.splits.split(",")]:
                if -(-mg // rows) < R:
                    continue
                out = forward_at_split(two, mats, w, u0, c, n, rows)
                same = all(torch.equal(a, b) for a, b in zip(out, (uT, J, traj)))
                ms = gpu_ms(lambda: forward_at_split(two, mats, w, u0, c, n, rows), 10)
                print(f"{tag} row forward R={R} mg={mg} N={n} rows/CTA={rows} "
                      f"CTAs={-(-mg // rows)}: {ms:.3f} ms, bitwise the wrapper's {same} "
                      f"[{name}]", flush=True)
            print(f"{tag} row reverse R={R}: {gpu_ms(lambda: br(uT, traj), 10):.3f} ms; "
                  f"{R} one-row forwards {gpu_ms(lambda: [f1(u0[r]) for r in range(R)], 10):.3f} "
                  f"ms, reverses "
                  f"{gpu_ms(lambda: [b1(uT[r], traj[r], sc[r]) for r in range(R)], 10):.3f} ms "
                  f"[{name}]", flush=True)


if __name__ == "__main__":
    main()
