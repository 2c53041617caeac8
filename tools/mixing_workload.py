"""Run the optimal-mixing reference workload of the PyTorch port to its end
on one NVIDIA GPU, at each dtype asked for, from the same x0, and report
where and why each run stopped.

    python tools/mixing_workload.py [--dtypes float32,float64] [--save FILE]

The workload is `bench.py`'s mixing_workload: 256x128, dt = 5e-3, 1000
SBDF1 steps, s = 1 (mix-norm), Wolfe + CG, alpha0 = 100, err_tol 1e-6,
at most 200 iterations, from the f32 seed-42 IC of
`baselines/mixing256_truth.npz`. Each run goes through
`spheremanopt_torch.run`'s own `make_problem` and `optimise` with
`--device-loop` (the device loop on CUDA graphs). It prints, for each
dtype, the iterations, the end point, the last recorded residual and
the reason the loop stopped (err_tol met, max_iters, or a search that
found no step: a failed or non-finite Wolfe search), the wall time with
warm-up and capture, and, for each pair of dtypes, the relative
difference of their function values iteration by iteration.
`--save` writes the histories as JSON.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from spheremanopt_torch import run as cli  # noqa: E402
from spheremanopt_torch.utils.profiling import card_name  # noqa: E402


def run_one(dtype, x0, out_dir):
    args = cli.build_parser().parse_args(
        ["mixing", "--device", "cuda", "--dtype", dtype, "--device-loop",
         "--quiet", "--out-dir", out_dir])
    p, x, d = cli.make_problem(args, x0=[x0])
    err_tol, max_iters, _ = cli._settings(d, args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = cli.optimise(p, x, d, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k = int(r.iterations)
    fv = r.function_values[:k].double().cpu().numpy()
    st = r.step_sizes[:k].double().cpu().numpy()
    res = float(r.residuals[k - 1].max()) if k else float("nan")
    if res <= err_tol:
        reason = "err_tol met"
    elif k >= max_iters:
        reason = "max_iters"
    else:
        reason = "the next search found no step (failed or non-finite)"
    sphere = abs(float(p.inner_product(r.x_opt[0], r.x_opt[0])) / p.radii[0] - 1)
    return dict(dtype=dtype, iterations=k, J_end=float(fv[-1]) if k else None,
                last_residual=res, err_tol=err_tol, reason=reason, sphere=sphere,
                wall_s=wall, function_values=fv.tolist(), step_sizes=st.tolist())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--save", default=None, help="write the histories here")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mixing_workload: no CUDA device", file=sys.stderr)
        return 1
    card = card_name()
    x0 = np.load(os.path.join(HERE, "baselines", "mixing256_truth.npz"))["x0"]
    out_dir = os.path.join(HERE, "build", "mixing_workload")
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for dtype in a.dtypes.split(","):
        r = run_one(dtype, x0, out_dir)
        runs.append(r)
        print(f"[{dtype}] {r['iterations']} iterations to J {r['J_end']!r}; last "
              f"residual {r['last_residual']:.3e} (err_tol {r['err_tol']:g}): "
              f"{r['reason']}; |<x,x>/r-1| {r['sphere']:.1e}; {r['wall_s']:.2f} s "
              f"with the warm-up and capture [{card}]", flush=True)
        print(f"  values {r['function_values']}", flush=True)
        print(f"  steps {r['step_sizes']}", flush=True)
    for i in range(len(runs)):
        for j in range(i + 1, len(runs)):
            fa = np.asarray(runs[i]["function_values"])
            fb = np.asarray(runs[j]["function_values"])
            n = min(len(fa), len(fb))
            d = np.abs(fa[:n] - fb[:n]) / np.abs(fb[:n])
            print(f"[{runs[i]['dtype']} vs {runs[j]['dtype']}] rel difference of "
                  f"the values over their first {n} iterations: "
                  + ", ".join(f"{v:.1e}" for v in d), flush=True)
    if a.save:
        os.makedirs(os.path.dirname(os.path.abspath(a.save)), exist_ok=True)
        with open(a.save, "w") as f:
            json.dump(dict(card=card, runs=runs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
