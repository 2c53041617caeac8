"""Time the fused sweep kernels and the operator-cotangent product of one
checkout of the PyTorch port on one NVIDIA GPU, for comparing two
checkouts in turns on one card.

    python tools/time_reverse_sweeps.py [--root DIR] [--tag NAME]
        [--save DIR] [--against NAME]

`--root` is the checkout whose `spheremanopt_torch` is imported (default:
this one); its kernels are built there at first use. By CUDA events over
20 calls after 2 warm-up calls (5 for the longer calls) it times:
  * at the SH23 width (B = M of `SH23Config()`, mg = 512, N = 1000) and
    the SHB23 width (A, B of `SHB23Config()`, mg = 512, N = 2000) the
    reverse sweep without the lambda history (`fused_bwd_shared`,
    `fused_bwd`) and, where the checkout has it, with it (`lam_hist=`);
  * the SHB23 forward sweep (`fused_fwd`, with the trajectory, and with
    the series) at mg = 512, N = 2000, and at mg = 1024, N = 200 (SHB23's
    operators at npts = 1024: the one-block route where the checkout has
    two routes);
  * the SHB23 fwd+grad unit (`objective_and_gradient`, method "cuda");
  * `op_grads_product` at both widths on the sweeps' own lambda history,
    in a CUDA graph of 20 calls (device time) and per plain call (with
    the host's time), beside `torch.matmul` of the same operands;
  * the KDyn reverse sweep (`run_bwd`, 24^3 modes, 2000 steps, cost
    Final, from the pinned x0 of `baselines/kdyn_port_ref.npz`; 5 calls
    after 1) and the KDyn fwd+grad unit (`objective_and_gradient`,
    method "cuda"; 3 calls after 1);
  * the largest |lambda_0 - plain f32| of the SHB23 reverse sweep and
    |(b0_bar, u_bar) - plain f32| of the KDyn one (one plain sweep each,
    ~10 s for KDyn).
It prints one JSON line with the card's name and power limit. With
`--save DIR` it writes the SHB23 forward's u_T and trajectory (mg = 512)
and the SHB23 reverse sweep's lambda_0 to DIR/<tag>.npz, and with
`--against NAME` it prints the largest |u_T - u_T(NAME)|,
|traj - traj(NAME)| and |lambda_0 - lambda_0(NAME)| against
DIR/NAME.npz. Run parent, change, change, parent, each in its own
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
    x2 = q.generate_ic(seed=42)
    out["shb23_unit_ms"] = gpu_ms(lambda: q.objective_and_gradient(x2), 5)
    lam2 = fk.fused_bwd(a2, b2, w2, uT2, tr2, 2.0, -1.0, sc2, n2)[0]
    lam2_p = fk.fused_bwd_plain(a2, b2, w2, uT2, tr2, 2.0, -1.0, sc2, n2)[0]
    out["shb23_bwd_max_abs_vs_plain"] = float((lam2 - lam2_p).abs().max())

    # the KDyn reverse sweep and the KDyn fwd+grad unit, from the pinned x0
    from spheremanopt_torch.ops.cuda import kdyn_step as kd
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    ref = np.load(os.path.join(HERE, "baselines", "kdyn_port_ref.npz"))
    xk = [torch.as_tensor(ref[k].astype(np.float32), device=dev) for k in ("b0", "u0")]
    pk = KinematicDynamo(KDynConfig(dtype="float32", method="cuda"), device=dev)
    with torch.no_grad():
        b0_c, uk = pk._prepare(xk)
    br0, bi0, uk = b0_c.real.contiguous(), b0_c.imag.contiguous(), uk.contiguous()
    Ck, nk, dtk = pk._consts, pk.cfg.n_iters, pk.cfg.dt
    brT, biT, _, trr, tri = kd.run_fwd_traj(br0, bi0, uk, Ck, nk, False, dtk)
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
    if args.save:
        os.makedirs(args.save, exist_ok=True)
        np.savez(os.path.join(args.save, f"{args.tag}.npz"), uT=uT2.cpu().numpy(),
                 traj=tr2.cpu().numpy(), lam0=lam2.cpu().numpy())
        if args.against:
            ref = np.load(os.path.join(args.save, f"{args.against}.npz"))
            out[f"max_abs_uT_vs_{args.against}"] = float(np.abs(uT2.cpu().numpy()
                                                               - ref["uT"]).max())
            out[f"max_abs_traj_vs_{args.against}"] = float(np.abs(tr2.cpu().numpy()
                                                                 - ref["traj"]).max())
            out[f"max_abs_lam0_vs_{args.against}"] = float(np.abs(lam2.cpu().numpy()
                                                                 - ref["lam0"]).max())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
