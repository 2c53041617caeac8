"""Run the port's example studies (`examples/torch_*.py`) once each on one
GPU at full width, one child process each, and record their walls and
JSON lines.

    python tools/examples_full_width.py [--out chiprun_out/examples_full_width.json]

Widths and depths are the examples' defaults: the KDyn Rm bisection is
the plain f32 Rm route at 24^3 and 2000 steps, 10 iterations a probe and
8 bisections (its first probe holds the warm-up and capture of the
loop's CUDA graphs), and the two mixing studies at 512x256 run 10
iterations (the continuation 10 coarse at 256x128 and 5 fine), their
operator cache off (`SMO_OP_CACHE=0`) so that each assembles its f64 tau
stacks cold. The sharded examples run as one torchrun rank each.

It also counts the kernel launches of one eager fwd+grad unit of the Rm
route at 20 and 40 steps (torch.profiler), which gives the launches a
step and, by a line through the two, the nodes a captured unit holds at
2000 steps.

Each line printed carries the card's name and power limit.
"""

import argparse
import json
import os
import resource
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

RUNS = [
    ("sh23_critical_seed", []),
    ("kdyn_critical_rm", []),
    ("lbfgs_vs_cg", ["sh23"]),
    ("lbfgs_vs_cg", ["kdyn"]),
    ("rtr_newton_vs_cg", []),
    ("regrid_warmstart", []),
    ("mixing512_df64_study", ["--out", "{tmp}/m512.npz"]),
    ("mixing_regrid_continuation", ["--out", "{tmp}/cont.json"]),
    ("kdyn_sharded_optimisation", []),
    ("mixing_sharded_optimisation", []),
]


def rm_route_launches(steps):
    """CUDA kernel launches of one eager fwd+grad unit of KDyn's Rm route
    (24^3, f32) at `steps` steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    p = KinematicDynamo(KDynConfig(n_iters=steps, dtype="float32"), device="cuda")
    fg, make_ops = p.objective_and_gradient_rm
    x, ops = p.generate_ic(seed=42), make_ops(2.0)
    fg(ops, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fg(ops, x)
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)


def main():
    from spheremanopt_torch.utils.profiling import card_name

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "examples_full_width.json"))
    ap.add_argument("--only", default=None, help="comma-separated example names")
    args = ap.parse_args()
    card = card_name()
    tmp = os.path.join(HERE, "build", "examples_full_width")
    os.makedirs(tmp, exist_ok=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    results = {"card": card, "runs": []}

    from spheremanopt_torch.ops.cuda import build as kbuild

    t0 = time.perf_counter()
    kbuild.load()   # once, before the children: none of their walls holds the build
    results["kernel_build_s"] = time.perf_counter() - t0

    n20, n40 = rm_route_launches(20), rm_route_launches(40)
    per_step = (n40 - n20) / 20
    results["rm_route_launches"] = {"20": n20, "40": n40, "per_step": per_step,
                                    "unit_at_2000": n20 + per_step * 1980}
    print(f"Rm route, one eager f32 fwd+grad unit at 24^3: {n20} launches at 20 steps, "
          f"{n40} at 40, {per_step:.1f} a step, ~{n20 + per_step * 1980:.0f} at 2000 "
          f"[{card}]", flush=True)

    only = set(args.only.split(",")) if args.only else None
    for name, argv in RUNS:
        if only and name not in only:
            continue
        argv = [a.replace("{tmp}", tmp) for a in argv] + ["--device", "cuda"]
        script = os.path.join(HERE, "examples", f"torch_{name}.py")
        cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "1", "--", script] if "sharded" in name
               else [sys.executable, script]) + argv
        run_env = dict(env, SMO_OP_CACHE="0") if "mixing" in name else env
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, cwd=HERE, env=run_env, capture_output=True, text=True,
                               timeout=1500)
            rc, out, err = r.returncode, r.stdout, r.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = "timeout", e.stdout or "", e.stderr or ""
            out = out.decode() if isinstance(out, bytes) else out
            err = err.decode() if isinstance(err, bytes) else err
        wall = time.perf_counter() - t0
        try:
            rec = json.loads(out.strip().splitlines()[-1])
        except (ValueError, IndexError):
            rec = None
        child_rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1024.0
        results["runs"].append({"name": name, "argv": argv, "rc": rc, "wall_s": wall,
                                "children_peak_rss_mb": child_rss, "result": rec,
                                "stderr_tail": err.strip().splitlines()[-5:]})
        lines = [ln for ln in out.strip().splitlines()[:-1] if ln.strip()][-6:]
        print(f"torch_{name}.py {' '.join(argv)}: exit {rc}, {wall:.1f} s of process "
              f"[{card}]", flush=True)
        for ln in lines:
            print("   " + ln[:300], flush=True)
        if rec is None:
            print("   no JSON line; stderr: " + " | ".join(err.strip().splitlines()[-5:]),
                  flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
