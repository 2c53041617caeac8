"""Time the KDyn sweep kernels of one checkout of the PyTorch port on one
NVIDIA GPU, one row and over a sweep's rows, for comparing two checkouts
in turns on one card.

    python tools/time_kdyn_rows.py [--root DIR] [--tag NAME] [--rows 1,2,4,8]
        [--save DIR] [--against NAME]

`--root` is the checkout whose `spheremanopt_torch` is imported (default:
this one); its kernels are built there at first use. At the KDyn
configuration's full size (`KDynConfig()`: 24^3 modes on the 36^3 grid,
2000 steps, f32 `cuda`, cost Final), from `generate_ic(seed=r)` for row
r, by CUDA events (5 calls after 1) it times the three one-row sweeps
(`run_forward`, `run_fwd_traj`, `run_bwd`) on row 0 and, where the
checkout has them, the row sweeps (`run_forward_rows`,
`run_fwd_traj_rows`, `run_bwd_rows`) at each R of `--rows` beside R
calls of the one-row sweeps (2 calls after 1), each row's outputs held
bitwise against the one-row sweeps'. It prints one JSON line with the
card's name and power limit. With `--save DIR` it writes the one-row
sweeps' outputs on row 0 (b_T, J, trajectory, b0_bar, u_bar; both costs)
to DIR/<tag>.pt, and with `--against NAME` it prints the largest
difference of each from DIR/NAME.pt (`max_abs_vs_NAME`: 0 where the two
checkouts' kernels give the same bits). Run parent, change, change,
parent, each in its own process, and compare within one call only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    ap.add_argument("--rows", default="1,2,4,8")
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_kdyn_rows: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from spheremanopt_torch.ops.cuda import kdyn_step as kd
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo
    from spheremanopt_torch.utils.profiling import card_name, gpu_ms

    dev = torch.device("cuda")
    p = KinematicDynamo(KDynConfig(dtype="float32", method="cuda"), device=dev)
    C, n, dt = p._consts, p.cfg.n_iters, p.cfg.dt
    rows = [int(v) for v in args.rows.split(",")]
    with torch.no_grad():
        preps = [p._prepare(p.generate_ic(seed=r)) for r in range(max(rows))]
    br0 = torch.stack([c.real for c, _ in preps])
    bi0 = torch.stack([c.imag for c, _ in preps])
    u = torch.stack([v for _, v in preps])
    gbar = torch.full((max(rows),), -1.0, device=dev)
    out = {"tag": args.tag, "root": os.path.abspath(args.root), "card": card_name()}

    def fwd1(r):
        return kd.run_forward(br0[r], bi0[r], u[r], C, n, False, dt)

    def traj1(r):
        return kd.run_fwd_traj(br0[r], bi0[r], u[r], C, n, False, dt)

    one = [traj1(r) for r in range(max(rows))]

    def bwd1(r):
        t = one[r]
        return kd.run_bwd(u[r], t[0], t[1], gbar[r].contiguous(), t[3], t[4], C, n, False,
                          dt)

    if args.save:
        outs = {}
        for integrated in (False, True):
            t = kd.run_fwd_traj(br0[0], bi0[0], u[0], C, n, integrated, dt)
            b = kd.run_bwd(u[0], t[0], t[1], gbar[0].contiguous(), t[3], t[4], C, n,
                           integrated, dt)
            for name, v in zip(("brT", "biT", "J", "trr", "tri", "b0r_bar", "b0i_bar",
                                "ubar"), (*t, *b)):
                outs[f"{name}_{integrated}"] = v.cpu()
        os.makedirs(args.save, exist_ok=True)
        torch.save(outs, os.path.join(args.save, f"{args.tag}.pt"))
        if args.against:
            ref = torch.load(os.path.join(args.save, f"{args.against}.pt"))
            out[f"max_abs_vs_{args.against}"] = {
                k: float((v.double() - ref[k].double()).abs().max()) for k, v in outs.items()}
        del outs
    out["fwd_ms"] = gpu_ms(lambda: fwd1(0), 5, 1)
    out["fwd_traj_ms"] = gpu_ms(lambda: traj1(0), 5, 1)
    out["bwd_ms"] = gpu_ms(lambda: bwd1(0), 5, 1)
    if hasattr(kd, "run_forward_rows"):
        for R in rows:
            s = slice(0, R)
            t = kd.run_fwd_traj_rows(br0[s], bi0[s], u[s], C, n, False, dt)
            f = kd.run_forward_rows(br0[s], bi0[s], u[s], C, n, False, dt)
            b = kd.run_bwd_rows(u[s], t[0], t[1], gbar[s], t[3], t[4], C, n, False, dt)
            same = all(
                all(torch.equal(x[r], y) for x, y in zip(t, one[r]))
                and all(torch.equal(x[r], y) for x, y in zip(f, one[r][:3]))
                and all(torch.equal(x[r], y) for x, y in zip(b, bwd1(r)))
                for r in range(R))
            out[f"R{R}"] = {
                "bitwise_one_row": same,
                "fwd_rows_ms": gpu_ms(lambda: kd.run_forward_rows(
                    br0[s], bi0[s], u[s], C, n, False, dt), 5, 1),
                "fwd_traj_rows_ms": gpu_ms(lambda: kd.run_fwd_traj_rows(
                    br0[s], bi0[s], u[s], C, n, False, dt), 5, 1),
                "bwd_rows_ms": gpu_ms(lambda: kd.run_bwd_rows(
                    u[s], t[0], t[1], gbar[s], t[3], t[4], C, n, False, dt), 5, 1),
                "fwd_one_row_calls_ms": gpu_ms(lambda: [fwd1(r) for r in range(R)], 2, 1),
                "fwd_traj_one_row_calls_ms": gpu_ms(
                    lambda: [traj1(r) for r in range(R)], 2, 1),
                "bwd_one_row_calls_ms": gpu_ms(lambda: [bwd1(r) for r in range(R)], 2, 1),
            }
            del t, f, b
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
