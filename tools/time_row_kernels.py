"""Time the row kernels (a sweep's R rows in one launch) of one checkout of
the PyTorch port on one NVIDIA GPU, for comparing two checkouts in turns
on one card.

    python tools/time_row_kernels.py [--root DIR] [--tag NAME] [--rows 1,2,4,8]
        [--groups 1,2] [--npts 512] [--sh23] [--probe [--stamps]] [--save DIR]
        [--against NAME]

`--root` is the checkout whose `spheremanopt_torch` is imported (default:
this one); its kernels are built there at first use. At SHB23's full
size (`SHB23Config()`: npts 512, N 2000; `--npts` another row-kernel
width, 128 .. 640), f32 `cuda`, from `generate_ic(seed=r)` for row r, by
CUDA events, it times for each R of `--rows` the row forward
(`fused_fwd_rows`) and the row reverse (`fused_bwd_rows`) as the wrappers
run them, beside R calls of the one-row kernels (`fused_fwd`,
`fused_bwd`), each row held bitwise against the one-row kernels (u_T, J,
trajectory, lambda_0). Where the checkout has the grouped row kernels
(csrc/fused_rows.cuh), it also launches them directly at each G of
`--groups`, each launch's rows bitwise the one-row kernels'. `--probe`
runs everything on a build with -DSMO_ROWS_PROBE (a library of its own),
whose kernels also record clock64() stamps; `--stamps` then prints after
each R the forward's and the reverse's SM cycles a step by part
(`stamp_summary`).
`--sh23` adds SH23's row kernels at full width (npts 256, N 1000). It
prints one JSON line a measurement, each with the card's name and power
limit, and the ptxas report of the row kernels' instances (registers,
spills) once. With `--save DIR` it writes the row kernels' outputs at the
largest R to DIR/<tag>.pt, and with `--against NAME` prints the largest
difference of each from DIR/NAME.pt (0 where the two checkouts' kernels
give the same bits). Run parent, change, change, parent, each in its own
process, and compare within one call only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = "-DSMO_ROWS_PROBE"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    ap.add_argument("--rows", default="1,2,4,8")
    ap.add_argument("--groups", default="1,2")
    ap.add_argument("--npts", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sh23", action="store_true")
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_row_kernels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from spheremanopt_torch.ops.cuda import build
    from spheremanopt_torch.ops.cuda import fused_two_matrix as fk
    from spheremanopt_torch.problems.swift_hohenberg_bounded import (
        SHB23Config,
        SwiftHohenbergBounded,
    )
    from spheremanopt_torch.utils.profiling import card_name, gpu_ms

    card = card_name()
    grouped = hasattr(fk, "fwd_rows_groups")
    if args.probe:
        lib = ctypes.CDLL(str(build.build([PROBE])))
        for name, argtypes in build.SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        build._lib = lib   # the wrappers launch through the probe build
    else:
        lib = build.load()
    base = {"tag": args.tag, "root": os.path.abspath(args.root), "card": card}

    def emit(**kw):
        print(json.dumps({**base, **kw}), flush=True)

    for name, regs, st, ld in (build.ptxas_report() if hasattr(build, "ptxas_report") else []):
        if "rows_kernel" in name:
            emit(ptxas=name, registers=regs, spill_stores=st, spill_loads=ld)

    dev = torch.device("cuda")
    q = SwiftHohenbergBounded(SHB23Config(npts=args.npts, dtype="float32", method="cuda"),
                              device=dev)
    a, b = q._Alt.float().contiguous(), q._Ant.float().contiguous()
    w, n, mg = q._wt.float().contiguous(), q.cfg.n_iters, args.npts
    c2, c3 = 2.0, -1.0
    rows_list = [int(v) for v in args.rows.split(",")]
    Rmax = max(rows_list)
    x = torch.stack([q.generate_ic(seed=s)[0] for s in range(Rmax)]).float().contiguous()
    sc = (-2.0 * q.cfg.dt) * torch.linspace(0.5, 1.5, Rmax, device=dev)
    st = lambda: torch.cuda.current_stream().cuda_stream   # noqa: E731
    ones = []
    for r in range(Rmax):
        u1, j1, t1, _ = fk.fused_fwd(a, b, w, x[r], c2, c3, n)
        ones.append((u1, j1, t1, fk.fused_bwd(a, b, w, u1, t1, c2, c3, sc[r].contiguous(), n)[0]))

    def same_fwd(out, R):
        return all(torch.equal(out[0][r], ones[r][0]) and torch.equal(out[1][r], ones[r][1])
                   and torch.equal(out[2][r], ones[r][2]) for r in range(R))

    def same_bwd(lam, R):
        return all(torch.equal(lam[r], ones[r][3]) for r in range(R))

    def fwd_direct(R, G):
        """The grouped row forward launched at G: ((outputs, launch) or None
        where the card cannot hold it, the CTAs it holds)."""
        if not fk.fwd_rows_fits(mg, R, G, fk._card(dev)[0]):
            return None, None
        groups, ctas, rows = fk.fwd_rows_groups(mg, R, G, fk._card(dev)[0])
        cap = lib.sm_fused_fwd_rows_capacity(mg, G, rows)
        if cap < groups * ctas:
            return None, cap
        uT, J = torch.empty_like(x[:R]), torch.empty(R, device=dev)
        traj = torch.empty((R, n, mg), device=dev)
        slots = torch.empty(4 * R * mg, device=dev)

        def launch():
            code = lib.sm_fused_fwd_rows(a.data_ptr(), b.data_ptr(), w.data_ptr(), x.data_ptr(),
                                         c2, c3, n, mg, G, ctas, rows, R, uT.data_ptr(),
                                         J.data_ptr(), traj.data_ptr(), slots.data_ptr(), st())
            if code != 0:
                raise RuntimeError(f"sm_fused_fwd_rows G={G}: cudaError_t {code}")
        return ((uT, J, traj), launch), cap

    def bwd_direct(R, G, uT, traj):
        cap = lib.sm_fused_bwd_rows_capacity(mg, G)
        if cap < 1:
            return None, cap
        lam = torch.empty_like(uT)

        def launch():
            code = lib.sm_fused_bwd_rows(a.data_ptr(), b.data_ptr(), w.data_ptr(), uT.data_ptr(),
                                         traj.data_ptr(), c2, c3, sc.data_ptr(), n, mg, G, R,
                                         lam.data_ptr(), st())
            if code != 0:
                raise RuntimeError(f"sm_fused_bwd_rows G={G}: cudaError_t {code}")
        return (lam, launch), cap

    saved = {}
    for R in rows_list:
        s = slice(0, R)
        out = fk.fused_fwd_rows(a, b, w, x[s], c2, c3, n)
        lam = fk.fused_bwd_rows(a, b, w, out[0], out[2], c2, c3, sc[s].contiguous(), n)
        torch.cuda.synchronize()
        if R == Rmax:
            saved = {"uT": out[0].cpu(), "J": out[1].cpu(), "traj": out[2].cpu(),
                     "lam": lam.cpu()}
        row = {"R": R, "mg": mg, "N": n,
               "bitwise_one_row": same_fwd(out, R) and same_bwd(lam, R),
               "fwd_rows_ms": gpu_ms(lambda: fk.fused_fwd_rows(a, b, w, x[s], c2, c3, n),
                                     args.reps),
               "bwd_rows_ms": gpu_ms(lambda: fk.fused_bwd_rows(
                   a, b, w, out[0], out[2], c2, c3, sc[s].contiguous(), n), args.reps),
               "fwd_one_row_calls_ms": gpu_ms(
                   lambda: [fk.fused_fwd(a, b, w, x[r], c2, c3, n) for r in range(R)], 3, 1),
               "bwd_one_row_calls_ms": gpu_ms(
                   lambda: [fk.fused_bwd(a, b, w, ones[r][0], ones[r][2], c2, c3,
                                         sc[r].contiguous(), n) for r in range(R)], 3, 1)}
        if grouped:
            row["fwd_group"] = fk.fwd_row_group(R, mg, fk._card(dev))
            row["bwd_group"] = fk.bwd_row_group(R, fk._rows_clusters(dev, mg))
        emit(route="wrappers", **row)
        if args.stamps:
            emit(stamps="fwd", R=R, G=row["fwd_group"],
                 **stamp_summary(lib, torch, row["fwd_group"], 0))
            emit(stamps="bwd", R=R, G=row["bwd_group"],
                 **stamp_summary(lib, torch, row["bwd_group"], 1))
        if not grouped:
            continue
        for G in (int(v) for v in args.groups.split(",")):
            if G > 1 and G >= 2 * R:
                continue   # the same launch as G = R's with idle rows
            got, cap = fwd_direct(R, G)
            if got is None:
                emit(kernel="fwd", R=R, G=G, capacity=cap, ms=None)
            else:
                fo, launch = got
                launch()
                torch.cuda.synchronize()
                emit(kernel="fwd", R=R, G=G, capacity=cap, bitwise_one_row=same_fwd(fo, R),
                     ms=gpu_ms(launch, args.reps))
            got, cap = bwd_direct(R, G, out[0], out[2])
            if got is None:
                emit(kernel="bwd", R=R, G=G, clusters_held=cap, ms=None)
                continue
            lo, launch = got
            launch()
            torch.cuda.synchronize()
            emit(kernel="bwd", R=R, G=G, clusters_held=cap, clusters=-(-R // G),
                 bitwise_one_row=same_bwd(lo, R), ms=gpu_ms(launch, args.reps))
    if args.save:
        os.makedirs(args.save, exist_ok=True)
        torch.save(saved, os.path.join(args.save, f"{args.tag}.pt"))
        if args.against:
            ref = torch.load(os.path.join(args.save, f"{args.against}.pt"))
            emit(**{f"max_abs_vs_{args.against}": {
                k: float((v.double() - ref[k].double()).abs().max()) for k, v in saved.items()}})
    if args.sh23:
        sh23_rows(fk, torch, gpu_ms, emit, rows_list, args.reps)
    return 0


MARKS = 5   # clock64() stamps a step (csrc/fused_rows.cuh kProbeMarks)
SEGMENTS = {0: ("products", "stores", "traj_energy", "barrier", "poll"),
            1: ("chains", "partials", "combine_dsmem", "cluster_sync", "next")}


def stamp_summary(lib, torch, G, kernel):
    """Mean SM cycles of each part of a step from the probe build's stamps
    (csrc/fused_rows.cuh probe_stamp) of the last launch of G's kernel (0
    forward, 1 reverse), over its CTAs and 15 steps; the forward's parts:
    the products, the warp sums and tagged stores, the trajectory and the
    energy, the step's last barrier, the poll of the next state; the
    reverse's: its chains, the partials' barrier, the combine and its
    stores to the cluster, cluster.sync(), the gap to the next step. Also
    the slowest CTA's mean step part before its barrier."""
    buf = torch.zeros(2 * 256 * 16 * MARKS, dtype=torch.int64)
    code = getattr(lib, f"smo_rows_stamps_g{G}")(ctypes.c_void_p(buf.data_ptr()))
    if code != 0:
        raise RuntimeError(f"smo_rows_stamps_g{G}: cudaError_t {code}")
    st = buf.view(2, 256, 16, MARKS)[kernel].double()
    st = st[st[:, 0, 0] != 0]   # the CTAs the launch had
    out = {"ctas": int(st.shape[0])}
    for m, name in enumerate(SEGMENTS[kernel][:-1]):
        out[name] = float((st[:, :-1, m + 1] - st[:, :-1, m]).mean())
    out[SEGMENTS[kernel][-1]] = float((st[:, 1:, 0] - st[:, :-1, MARKS - 1]).mean())
    out["before_barrier_max_cta"] = float((st[:, :-1, MARKS - 2] - st[:, :-1, 0]).mean(1).max())
    out["step"] = float((st[:, 1:, MARKS - 1] - st[:, :-1, MARKS - 1]).mean())
    return out


def sh23_rows(fk, torch, gpu_ms, emit, rows_list, reps):
    """SH23's row kernels at full width (npts 256, mg 512, N 1000), beside
    R calls of its one-row kernels."""
    from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg

    dev = torch.device("cuda")
    p = SwiftHohenberg(SH23Config(dtype="float32", method="cuda"), device=dev)
    mg, n, lin = p.basis.n_grid, p.cfg.n_iters, 1.0 / p.cfg.dt
    b = p._Mt.float().contiguous()
    w = torch.full((mg,), 1.0 / mg, device=dev)
    for R in rows_list:
        x = torch.stack([p.generate_ic(seed=s)[0] for s in range(R)]).float()
        u0 = torch.matmul(x, p._Pt.float().t()).contiguous()
        sc = (-2.0 * p.cfg.dt) * torch.linspace(0.5, 1.5, R, device=dev)
        uT, J, traj = fk.fused_fwd_shared_rows(b, w, u0, 1.8, -1.0, lin, n)
        emit(route="sh23 wrappers", R=R, mg=mg, N=n,
             fwd_rows_ms=gpu_ms(lambda: fk.fused_fwd_shared_rows(b, w, u0, 1.8, -1.0, lin, n),
                                reps),
             bwd_rows_ms=gpu_ms(lambda: fk.fused_bwd_shared_rows(
                 b, w, uT, traj, 1.8, -1.0, lin, sc, n), reps))


if __name__ == "__main__":
    sys.exit(main())
