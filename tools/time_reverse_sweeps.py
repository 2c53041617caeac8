"""Time the fused sweep kernels and the operator-cotangent product of one
checkout of the PyTorch port on one NVIDIA GPU, for comparing two
checkouts in turns on one card.

    python tools/time_reverse_sweeps.py [--root DIR] [--tag NAME]
        [--save DIR] [--against NAME]

`--root` is the checkout whose `spheremanopt_torch` is imported (default:
this one); its kernels are built there at first use. By CUDA events over
20 calls after 2 warm-up calls (5 for the longer calls) it times:
  * at the SH23 width (B = M of `SH23Config()`, mg = 512, N = 1000) the
    forward sweep (`fused_fwd_shared`, with the trajectory, and with the
    series), and at the SH23 and the SHB23 width (A, B of `SHB23Config()`,
    mg = 512, N = 2000) the reverse sweep without the lambda history
    (`fused_bwd_shared`, `fused_bwd`) and, where the checkout has it, with
    it (`lam_hist=`);
  * the SHB23 forward sweep (`fused_fwd`, with the trajectory, and with
    the series) at mg = 512, N = 2000, and at mg = 1024, N = 200 (SHB23's
    operators at npts = 1024: the checkout's route at that width); where
    the checkout has them, the one-block kernel `sm_fused_fwd_block`
    called directly at mg = 1024; and `fused_fwd` at mg = 128, 256, 384
    and 640 (N = 2000, seeded operators), on the checkout's route;
  * the SH23 and SHB23 fwd+grad units (`objective_and_gradient`, method
    "cuda", from `generate_ic(seed=42)`; 5 calls after 2);
  * `op_grads_product` at both widths on the sweeps' own lambda history,
    in a CUDA graph of 20 calls (device time) and per plain call (with
    the host's time), beside `torch.matmul` of the same operands;
  * the KDyn forward sweeps (`run_forward` and `run_fwd_traj`) and the
    reverse sweep (`run_bwd`), 24^3 modes, 2000 steps, cost Final, from
    the pinned x0 of `baselines/kdyn_port_ref.npz` (5 calls after 1), and
    the KDyn fwd+grad unit (`objective_and_gradient`, method "cuda"; 3
    calls after 1);
  * the forwards above the clusters' widths at N = 200, each on the
    checkout's route and as the one-block kernel called directly, with
    and without the series: SHB23 (`fused_fwd`) at mg = 1920 and 2048
    (SHB23's operators at npts = mg) and SH23 (`fused_fwd_shared`) at
    mg = 1024, 1536 and 2048 (SH23's operators at npts = mg / 2); and
    the SH23 forward at mg = 128, 256, 512, 640 and 896 on the
    checkout's route (10 calls after 2 each);
  * the reverse sweeps at N = 200 (`fused_bwd`, `fused_bwd_shared`), each
    with and without the lambda history, on the checkout's route at
    mg = 128, 256, 384, 512, 640, 768, 896, 1024 and 2048 (SHB23's
    operators at npts = mg from 1024 on, seeded operators below; SH23's
    operators at npts = mg / 2), where the checkout has them as the grid
    kernels called directly at each of those widths (`_bwd_grid`,
    `_bwd_shared_grid`), and at mg = 1024 and 2048 also as the one-block
    kernels called directly (`_bwd_block`, `_bwd_shared_block`; 10 calls
    after 2, 3 after 2 for the one-block kernels at 2048);
  * the largest difference from plain f32 of the SH23 forward
    (|u_T|, |traj|), the SHB23 reverse sweep (|lambda_0|), the KDyn
    forward (|(b_T, J, traj)|) and the KDyn reverse sweep
    (|(b0_bar, u_bar)|) (one plain sweep each, ~10 s for each KDyn one).
It prints one JSON line with the card's name and power limit. With
`--save DIR` it writes the SH23 forward's u_T and trajectory, the SH23
reverse sweep's lambda_0 and lambda history, the SHB23 forward's u_T and
trajectory (mg = 512), the SHB23 reverse sweep's lambda_0, the SHB23
forward's u_T, J, trajectory and series at mg = 1024 and the forward's
u_T, J and series at mg = 128, 256, 384 and 640, and the u_T, J,
trajectory and series of the forwards above at every width, and the
lambda_0 and lambda history of every reverse sweep at N = 200 above, to
DIR/<tag>.npz,
and with `--against NAME` it prints the largest difference of each from
DIR/NAME.npz (`max_abs_<what>_vs_NAME`).
Run parent, change, change, parent, each in its own process, and compare
within one call only.
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


def graph_ms(fn, reps=20, replays=5):
    """Mean ms per call: CUDA events around replays of one CUDA graph of
    `reps` calls (no host time per call)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return gpu_ms(g.replay, replays) / reps


def wide_forwards(fk, dev, out):
    """Time the forwards above the clusters' widths and the SH23 grid
    beside its cluster; return their outputs (u_T, J, trajectory and
    series, each with the series) by name."""
    import numpy as np
    import torch

    from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg
    from spheremanopt_torch.problems.swift_hohenberg_bounded import (
        SHB23Config, SwiftHohenbergBounded)

    saved = {}
    for m in (1920, 2048):   # SHB23 forward, N = 200: the route and the one-block kernel
        r = SwiftHohenbergBounded(SHB23Config(npts=m, dtype="float32", method="cuda"),
                                  device=dev)
        a, b, w = r._Alt.float().contiguous(), r._Ant.float().contiguous(), r._wt.float()
        u = torch.as_tensor(np.random.RandomState(m).randn(m), dtype=torch.float32, device=dev)
        u = u * torch.sqrt(r.cfg.m0 / torch.sum(w * u * u))
        opnds = (a, b, w, u, 2.0, -1.0, 200)
        out[f"shb23_fwd_{m}_ms"] = gpu_ms(lambda: fk.fused_fwd(*opnds), 10)
        out[f"shb23_fwd_{m}_ser_ms"] = gpu_ms(lambda: fk.fused_fwd(*opnds, store_series=True), 10)
        out[f"shb23_fwd_{m}_block_ms"] = gpu_ms(lambda: fk._fwd_block(*opnds), 10)
        out[f"shb23_fwd_{m}_block_ser_ms"] = gpu_ms(lambda: fk._fwd_block(*opnds, True, True), 10)
        got = fk.fused_fwd(*opnds, store_series=True)
        saved.update(zip((f"shb23_{m}_uT", f"shb23_{m}_J", f"shb23_{m}_traj", f"shb23_{m}_ser"),
                         got))
        blk = fk._fwd_block(*opnds, True, True)
        out[f"shb23_fwd_{m}_max_abs_vs_block"] = max(float((x - y).abs().max())
                                                     for x, y in zip(got, blk))
    for m in (128, 256, 512, 640, 896, 1024, 1536, 2048):   # SH23 forward, N = 200
        p = SwiftHohenberg(SH23Config(npts=m // 2, dtype="float32", method="cuda"), device=dev)
        b = p._Mt.float().contiguous()
        w = torch.full((m,), 1.0 / m, device=dev)
        x = torch.as_tensor(np.random.RandomState(m).randn(m), dtype=torch.float32, device=dev)
        opnds = (b, w, torch.mv(p._Pt.float(), x) * 0.3, 1.8, -1.0, 1.0 / p.cfg.dt, 200)
        out[f"sh23_fwd_{m}_ms"] = gpu_ms(lambda: fk.fused_fwd_shared(*opnds), 10)
        got = fk.fused_fwd_shared(*opnds, store_series=True)
        saved.update(zip((f"sh23_{m}_uT", f"sh23_{m}_J", f"sh23_{m}_traj", f"sh23_{m}_ser"), got))
        if m > 896:
            out[f"sh23_fwd_{m}_ser_ms"] = gpu_ms(
                lambda: fk.fused_fwd_shared(*opnds, store_series=True), 10)
            out[f"sh23_fwd_{m}_block_ms"] = gpu_ms(lambda: fk._fwd_shared_block(*opnds), 10)
            out[f"sh23_fwd_{m}_block_ser_ms"] = gpu_ms(
                lambda: fk._fwd_shared_block(*opnds, True, True), 10)
            other = fk._fwd_shared_block(*opnds, True, True)
            out[f"sh23_fwd_{m}_max_abs_vs_block"] = max(float((x - y).abs().max())
                                                        for x, y in zip(got, other))
    return saved


def reverses(fk, dev, out):
    """Time the reverse sweeps at N = 200 on the checkout's route, with
    and without the lambda history, and at mg = 1024 and 2048 the
    one-block kernels beside them; return each route's lambda_0 and
    history by name."""
    import numpy as np
    import torch

    from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg
    from spheremanopt_torch.problems.swift_hohenberg_bounded import (
        SHB23Config, SwiftHohenbergBounded)

    def timed(tag, m, bwd, block, grid, args, traj):
        hist = torch.empty_like(traj)
        out[f"{tag}_bwd_{m}_ms"] = gpu_ms(lambda: bwd(*args), 10)
        out[f"{tag}_bwd_{m}_hist_ms"] = gpu_ms(lambda: bwd(*args, lam_hist=hist), 10)
        if grid is not None:
            out[f"{tag}_bwd_{m}_grid_ms"] = gpu_ms(lambda: grid(*args), 10)
            out[f"{tag}_bwd_{m}_grid_hist_ms"] = gpu_ms(lambda: grid(*args, hist), 10)
        lam = bwd(*args, lam_hist=hist)[0]
        if m >= 1024:
            out[f"{tag}_bwd_{m}_block_ms"] = gpu_ms(lambda: block(*args), 10 if m == 1024 else 3)
            out[f"{tag}_bwd_{m}_max_abs_vs_block"] = float((lam - block(*args)).abs().max())
        return {f"{tag}_bwd_{m}_lam": lam, f"{tag}_bwd_{m}_hist": hist}

    saved = {}
    for m in (128, 256, 384, 512, 640, 768, 896, 1024, 2048):
        rs = np.random.RandomState(m + 1)
        if m >= 1024:   # SHB23's operators
            r = SwiftHohenbergBounded(SHB23Config(npts=m, dtype="float32", method="cuda"),
                                      device=dev)
            a, b, w = r._Alt.float().contiguous(), r._Ant.float().contiguous(), r._wt.float()
            u = torch.as_tensor(rs.randn(m), dtype=torch.float32, device=dev)
            u = u * torch.sqrt(r.cfg.m0 / torch.sum(w * u * u))
        else:           # seeded operators of spectral radius ~0.5
            a, b = (torch.as_tensor(0.5 * rs.randn(m, m) / np.sqrt(m), dtype=torch.float32,
                                    device=dev) for _ in range(2))
            w = torch.full((m,), 1.0 / m, device=dev)
            u = torch.as_tensor(0.3 * rs.randn(m), dtype=torch.float32, device=dev)
        uT, _, tr, _ = fk.fused_fwd(a, b, w, u, 2.0, -1.0, 200)
        sc = torch.tensor(-0.02, device=dev)
        saved.update(timed("shb23", m, fk.fused_bwd, fk._bwd_block, getattr(fk, "_bwd_grid", None),
                           (a, b, w, uT, tr, 2.0, -1.0, sc, 200), tr))
        p = SwiftHohenberg(SH23Config(npts=m // 2, dtype="float32", method="cuda"), device=dev)
        bs = p._Mt.float().contiguous()
        ws = torch.full((m,), 1.0 / m, device=dev)
        x = torch.as_tensor(rs.randn(m), dtype=torch.float32, device=dev)
        lin = 1.0 / p.cfg.dt
        uT, _, tr, _ = fk.fused_fwd_shared(bs, ws, torch.mv(p._Pt.float(), x) * 0.3, 1.8, -1.0,
                                           lin, 200)
        sc = torch.tensor(-2.0 * p.cfg.dt, device=dev)
        saved.update(timed("sh23", m, fk.fused_bwd_shared, fk._bwd_shared_block,
                           getattr(fk, "_bwd_shared_grid", None),
                           (bs, ws, uT, tr, 1.8, -1.0, lin, sc, 200), tr))
    return saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--tag", default="")
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
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
    out["sh23_fwd_ms"] = gpu_ms(lambda: fk.fused_fwd_shared(b, w, u0, 1.8, -1.0, lin, n))
    out["sh23_fwd_ser_ms"] = gpu_ms(lambda: fk.fused_fwd_shared(
        b, w, u0, 1.8, -1.0, lin, n, store_series=True))
    uT_p, _, tr_p, _ = fk.fused_fwd_shared_plain(b, w, u0, 1.8, -1.0, lin, n)
    out["sh23_fwd_max_abs_vs_plain"] = max(float((uT - uT_p).abs().max()),
                                           float((tr - tr_p).abs().max()))
    xs = p.generate_ic(seed=42)
    out["sh23_unit_ms"] = gpu_ms(lambda: p.objective_and_gradient(xs), 5)
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

    # the SHB23 forward sweep, both widths, and the fwd+grad unit
    out["shb23_fwd_ms"] = gpu_ms(lambda: fk.fused_fwd(a2, b2, w2, u2, 2.0, -1.0, n2))
    out["shb23_fwd_ser_ms"] = gpu_ms(lambda: fk.fused_fwd(
        a2, b2, w2, u2, 2.0, -1.0, n2, store_series=True))
    r = SwiftHohenbergBounded(SHB23Config(npts=1024, dtype="float32", method="cuda"),
                              device=dev)
    a3, b3, w3 = r._Alt.float().contiguous(), r._Ant.float().contiguous(), r._wt.float()
    u3 = torch.as_tensor(np.random.RandomState(3).randn(1024), dtype=torch.float32,
                         device=dev)
    u3 = u3 * torch.sqrt(r.cfg.m0 / torch.sum(w3 * u3 * u3))
    out["shb23_fwd_1024_ms"] = gpu_ms(lambda: fk.fused_fwd(a3, b3, w3, u3, 2.0, -1.0, 200))
    out["shb23_fwd_1024_ser_ms"] = gpu_ms(lambda: fk.fused_fwd(
        a3, b3, w3, u3, 2.0, -1.0, 200, store_series=True))

    if hasattr(fk, "_fwd_block"):   # else the checkout's route at mg = 1024 is the block
        out["shb23_fwd_1024_block_ms"] = gpu_ms(
            lambda: fk._fwd_block(a3, b3, w3, u3, 2.0, -1.0, 200))
        out["shb23_fwd_1024_block_ser_ms"] = gpu_ms(
            lambda: fk._fwd_block(a3, b3, w3, u3, 2.0, -1.0, 200, True, True))
    # the forward's route at the other widths up to 640 (N = 2000), on
    # seeded operators of spectral radius ~0.5
    narrow = {}
    for m in (128, 256, 384, 640):
        rs = np.random.RandomState(m)
        am, bm = (torch.as_tensor(0.5 * rs.randn(m, m) / np.sqrt(m), dtype=torch.float32,
                                  device=dev) for _ in range(2))
        wm = torch.full((m,), 1.0 / m, device=dev)
        um = torch.as_tensor(0.3 * rs.randn(m), dtype=torch.float32, device=dev)
        narrow[m] = (am, bm, wm, um, 2.0, -1.0, n2)
        out[f"fwd_{m}_ms"] = gpu_ms(lambda o=narrow[m]: fk.fused_fwd(*o))
    x2 = q.generate_ic(seed=42)
    out["shb23_unit_ms"] = gpu_ms(lambda: q.objective_and_gradient(x2), 5)
    lam2 = fk.fused_bwd(a2, b2, w2, uT2, tr2, 2.0, -1.0, sc2, n2)[0]
    lam2_p = fk.fused_bwd_plain(a2, b2, w2, uT2, tr2, 2.0, -1.0, sc2, n2)[0]
    out["shb23_bwd_max_abs_vs_plain"] = float((lam2 - lam2_p).abs().max())

    # the KDyn sweeps and the KDyn fwd+grad unit, from the pinned x0
    from spheremanopt_torch.ops.cuda import kdyn_step as kd
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    ref = np.load(os.path.join(HERE, "baselines", "kdyn_port_ref.npz"))
    xk = [torch.as_tensor(ref[k].astype(np.float32), device=dev) for k in ("b0", "u0")]
    pk = KinematicDynamo(KDynConfig(dtype="float32", method="cuda"), device=dev)
    with torch.no_grad():
        b0_c, uk = pk._prepare(xk)
    br0, bi0, uk = b0_c.real.contiguous(), b0_c.imag.contiguous(), uk.contiguous()
    Ck, nk, dtk = pk._consts, pk.cfg.n_iters, pk.cfg.dt
    fwd_k = kd.run_fwd_traj(br0, bi0, uk, Ck, nk, False, dtk)
    brT, biT, _, trr, tri = fwd_k
    out["kdyn_fwd_ms"] = gpu_ms(lambda: kd.run_forward(br0, bi0, uk, Ck, nk, False, dtk), 5, 1)
    out["kdyn_fwd_traj_ms"] = gpu_ms(
        lambda: kd.run_fwd_traj(br0, bi0, uk, Ck, nk, False, dtk), 5, 1)
    want = kd.run_fwd_traj_plain(br0, bi0, uk, Ck, nk, False, dtk)
    out["kdyn_fwd_max_abs_vs_plain"] = max(float((x - y).abs().max())
                                           for x, y in zip(fwd_k, want))
    gk = torch.tensor(-1.0, device=dev)
    bwd_k = lambda: kd.run_bwd(uk, brT, biT, gk, trr, tri, Ck, nk, False, dtk)
    out["kdyn_bwd_ms"] = gpu_ms(bwd_k, 5, 1)
    out["kdyn_unit_ms"] = gpu_ms(lambda: pk.objective_and_gradient(xk), 3, 1)
    got = bwd_k()
    want = kd.run_bwd_plain(uk, brT, biT, gk, trr, tri, Ck, nk, False, dtk)
    out["kdyn_bwd_max_abs_vs_plain"] = max(float((x - y).abs().max())
                                           for x, y in zip(got, want))

    # the operator-cotangent product on the sweeps' own history
    if has_hist:
        for tag, hist_, tr_, mode, c, lin_ in (
                ("sh23", hist, tr, "shared", (1.8, -1.0), lin),
                ("shb23", hist2, tr2, "two", (2.0, -1.0), 0.0)):
            fcat = torch.cat(fk.op_factors(tr_, mode, *c, lin_), dim=1)
            prod = (lambda h=hist_, t=tr_, m=mode, c=c, l=lin_:
                    fk.op_grads_product(h, t, m, *c, l))
            lib = lambda h=hist_, f=fcat: torch.matmul(h.T, f)
            out[f"{tag}_prod_graph_us"] = 1e3 * graph_ms(prod)
            out[f"{tag}_matmul_graph_us"] = 1e3 * graph_ms(lib)
            out[f"{tag}_prod_call_us"] = 1e3 * gpu_ms(prod)
            out[f"{tag}_matmul_call_us"] = 1e3 * gpu_ms(lib)

    uT2, _, tr2, _ = fk.fused_fwd(a2, b2, w2, u2, 2.0, -1.0, n2)
    saved = wide_forwards(fk, dev, out)
    saved.update(reverses(fk, dev, out))
    if args.save:
        os.makedirs(args.save, exist_ok=True)
        saved.update(sh23_uT=uT, sh23_traj=tr, uT=uT2, traj=tr2, lam0=lam2)
        wide = fk.fused_fwd(a3, b3, w3, u3, 2.0, -1.0, 200, store_series=True)
        saved.update(zip(("wide_uT", "wide_J", "wide_traj", "wide_ser"), wide))
        for m, opnds in narrow.items():
            got = fk.fused_fwd(*opnds, store_traj=False, store_series=True)
            saved.update({f"fwd_{m}_uT": got[0], f"fwd_{m}_J": got[1],
                          f"fwd_{m}_ser": got[3]})
        saved["sh23_lam0"] = fk.fused_bwd_shared(b, w, uT, tr, 1.8, -1.0, lin, sc, n)[0]
        if has_hist:
            hist = torch.empty_like(tr)
            fk.fused_bwd_shared(b, w, uT, tr, 1.8, -1.0, lin, sc, n, lam_hist=hist)
            saved["sh23_hist"] = hist
        saved = {k: v.cpu().numpy() for k, v in saved.items()}
        np.savez(os.path.join(args.save, f"{args.tag}.npz"), **saved)
        if args.against:
            ref = np.load(os.path.join(args.save, f"{args.against}.npz"))
            for k, v in saved.items():
                out[f"max_abs_{k}_vs_{args.against}"] = float(np.abs(v - ref[k]).max())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
