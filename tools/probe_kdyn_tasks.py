"""Time one stage task of the KDyn sweep kernels at each row-group size on
one NVIDIA GPU, from clock64() stamps in a probe build.

    python tools/probe_kdyn_tasks.py [--groups 1,2,4] [--rows 4,8] [--steps 200]

Builds `csrc/kdyn_step.cu` and `csrc/kdyn_rows_g*.cu` with
`-DSMO_KDYN_PROBE` into a library of their own (the port's own build is
untouched): thread 0 of every block then stamps clock64() at the start of
each stage and at the end of each of its tasks for 8 steps, and block 0
stamps (clock64, globaltimer) at the launch's start and end, which give
the SM clock. At the KDyn configuration's full width (`KDynConfig()`:
24^3 modes on the 36^3 grid, f32 `cuda`, cost Final, `generate_ic(seed=r)`
for row r), for each row-group size G it launches the forward with the
trajectory and the reverse over R = G rows (G = 1: the one-row kernels),
so that each block runs at most one task of a stage where the card holds
a block a task, and over each R of --rows with every stage task stepping
G rows, and prints one JSON line: per (G, R, sweep) the median and largest
stage-YZ and stage-X task time (us), the median step time from the stamps
(us), the sweep's time a step by CUDA events over --steps steps (us), the
blocks and their tasks a stage, and least-squares fits t(G) = a + b G of
the median task times at R = G, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PROBE_FROM, PROBE_STEPS, PROBE_SLOTS = 4, 8, 8   # csrc/kdyn_step.cu kProbe*
SOURCES = ["kdyn_step.cu", "kdyn_rows_g2.cu", "kdyn_rows_g4.cu"]


def _fit(xs, ys):
    """Least-squares (a, b) of y = a + b x."""
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx if sxx else 0.0
    return my - b * mx, b


def _ptxas(log):
    """{kernel instance: its registers and spills} from nvcc's -Xptxas -v
    output."""
    out, log = {}, log.splitlines()
    for i, ln in enumerate(log):
        if "Compiling entry" in ln and "kdyn_" in ln:
            name = ln.split("'")[1]
            info = [x.split(":", 1)[-1].strip() for x in log[i + 1:i + 4]
                    if "Used" in x or "spill" in x]
            out[name[name.find("kdyn_"):][:64]] = "; ".join(info)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", default="1,2,4")
    ap.add_argument("--rows", default="4,8")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe_kdyn_tasks: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from spheremanopt_torch.ops.cuda import build
    from spheremanopt_torch.ops.cuda import kdyn_step as kd
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo
    from spheremanopt_torch.utils.profiling import card_name, gpu_ms

    lib = ctypes.CDLL(str(build.build(["-DSMO_KDYN_PROBE"], SOURCES)))
    for name, argtypes in build.SIGNATURES.items():
        if name.startswith("sm_kdyn"):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    lib.smo_kdyn_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    build._lib = lib   # the wrappers launch through the probe build
    ptxas = _ptxas(build.build_log)

    dev = torch.device("cuda")
    groups = [int(v) for v in args.groups.split(",")]
    rows = [int(v) for v in args.rows.split(",")]
    R_max = max(max(groups), *rows)
    n_probe = PROBE_FROM + PROBE_STEPS + 1
    p = KinematicDynamo(KDynConfig(dtype="float32", method="cuda"), device=dev)
    C, dt = p._consts, p.cfg.dt
    with torch.no_grad():
        preps = [p._prepare(p.generate_ic(seed=r)) for r in range(R_max)]
    br0 = torch.stack([c.real for c, _ in preps])
    bi0 = torch.stack([c.imag for c, _ in preps])
    u = torch.stack([v for _, v in preps])
    gbar = torch.full((R_max,), -1.0, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks_max = 2 * sms
    stamps = torch.zeros(4 + blocks_max * PROBE_STEPS * 2 * PROBE_SLOTS, dtype=torch.int64,
                         device=dev)

    def sweeps(R, n):
        s = slice(0, R)
        t = kd.run_fwd_traj_rows(br0[s], bi0[s], u[s], C, n, False, dt)
        return t, lambda: kd.run_bwd_rows(u[s], t[0], t[1], gbar[s], t[3], t[4], C, n,
                                          False, dt)

    def probed(G, R, which):
        """Stamps of one probed launch -> task and step times (us)."""
        lib.smo_kdyn_probe(stamps.data_ptr(), G)
        stamps.zero_()
        t, bwd = sweeps(R, n_probe) if which == "fwd_traj" else (None, None)
        got = None
        if which == "bwd":
            t, bwd = sweeps(R, n_probe)
            torch.cuda.synchronize()
            stamps.zero_()
            got = bwd()
        torch.cuda.synchronize()
        lib.smo_kdyn_probe(None, 0)
        st = stamps.cpu().numpy().astype(np.int64)
        # each row of the launch against the one-row kernels on it
        same = True
        for r in range(R):
            one = kd.run_fwd_traj(br0[r], bi0[r], u[r], C, n_probe, False, dt)
            same &= all(torch.equal(a[r], b) for a, b in zip(t, one))
            if which == "bwd":
                back = kd.run_bwd(u[r], one[0], one[1], gbar[r].contiguous(), one[3], one[4],
                                  C, n_probe, False, dt)
                same &= all(torch.equal(a[r], b) for a, b in zip(got, back))
        c0, g0, c1, g1 = (int(v) for v in st[:4])
        per_ns = (c1 - c0) / max(g1 - g0, 1)   # SM cycles a ns
        blk = st[4:].reshape(blocks_max, PROBE_STEPS, 2, PROBE_SLOTS)
        used = blk[:, 0, 0, 0] > 0
        blk = blk[used]
        out = {"bitwise_one_row": bool(same), "blocks": int(used.sum()),
               "sm_clock_ghz": per_ns}
        for stage, key in ((0, "yz"), (1, "x")):
            durs, first, ntasks = [], [], []
            for b in range(blk.shape[0]):
                for s in range(PROBE_STEPS):
                    v = blk[b, s, stage]
                    k = int((v > 0).sum())
                    d = np.diff(v[:k]) / per_ns / 1e3
                    durs += list(d)
                    first += list(d[:1])
                    ntasks.append(k - 1)
            out[f"{key}_task_us_median"] = float(np.median(durs)) if durs else None
            out[f"{key}_task_us_max"] = float(np.max(durs)) if durs else None
            out[f"{key}_first_task_us_median"] = float(np.median(first)) if first else None
            out[f"{key}_tasks_a_block_max"] = int(max(ntasks)) if ntasks else 0
        steps = np.diff(blk[:, :, 0, 0], axis=1) / per_ns / 1e3
        out["step_us_median"] = float(np.median(steps))
        return out

    res = {"card": card_name(), "device": torch.cuda.get_device_name(0), "sms": sms,
           "ptxas": ptxas, "cases": {}}
    for G in groups:
        for R in sorted({1 if G == 1 else G, *rows}):
            if G == 1 and R > 1:
                continue   # G = 1 is the one-row kernel
            for which in ("fwd_traj", "bwd"):
                case = probed(G, R, which)
                lib.smo_kdyn_probe(None, G)
                t, bwd = sweeps(R, args.steps)
                fn = bwd if which == "bwd" else (lambda: sweeps(R, args.steps)[0])
                case["sweep_us_a_step"] = gpu_ms(fn, 3, 1) * 1e3 / args.steps
                del t, bwd
                lib.smo_kdyn_probe(None, 0)
                res["cases"][f"G{G}_R{R}_{which}"] = case
    fits = {}
    for which in ("fwd_traj", "bwd"):
        for key in ("yz", "x"):
            xs = [G for G in groups if f"G{G}_R{1 if G == 1 else G}_{which}" in res["cases"]]
            ys = [res["cases"][f"G{G}_R{1 if G == 1 else G}_{which}"][f"{key}_task_us_median"]
                  for G in xs]
            a, b = _fit(xs, ys)
            fits[f"{which}_{key}"] = {"a_us": a, "b_us_a_row": b, "G": xs, "t_us": ys}
    res["fits"] = fits
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
