"""Regenerate baselines/examples_port_ref.npz — the JAX package's example
studies at small configurations, which the PyTorch port's
`examples/torch_*.py` are held against on a machine without JAX.

Every study runs with JAX on the CPU in f64 (x64). The JAX examples draw
their initial conditions with `jax.random`, which has no PyTorch
counterpart, so each study's x0 (and the noise it was made from) is
stored beside its outputs. The two bisections also run through the JAX
examples' own `main` with these flags, and their decisions and results
are asserted equal to the protocol re-run here (which keeps the
per-probe histories the examples do not print). The other studies re-run
their example's protocol with the JAX functions it calls:
`lbfgs_vs_cg.py` has its sizes hard-coded; `regrid_warmstart.py` runs
`method="pallas"` in f32 only, so here `method="matmul"` in f64; the
mixing studies' df64 solve is an f64 solve, so here the f64 config; the
sharded studies' decomposition does not change the values, so here one
process.

Keys, by prefix (`hist` arrays are padded with NaN past each run's end):
  seed_*   sh23_critical_seed.py --npts 48 --t-final 10 --bisections 3
           --max-iters 20: x0, noise, j_tiny, threshold, and per probe (lo,
           hi, then the bisections) e0, j, iters, hist, triggered; ec, bracket
  rm_*     kdyn_critical_rm.py --npts 8 --steps 50 --iters 3 --bisections 2:
           x0_b, x0_u, noise_b, noise_u, per probe rm, j, iters, hist, growth;
           rm_c, bracket
  lb_*     lbfgs_vs_cg.py: sh23 at npts 48, 50 steps, 20 iterations, and kdyn
           at npts 8, 20 steps, 3 iterations; per problem x0 (and noise),
           per direction iters and hist
  rtr_*    rtr_newton_vs_cg.py --npts 32 --n-iters 50 --max-iters 10: x0,
           noise; per driver iters, f, g, hvp, hist, res, converged
  ws_*     regrid_warmstart.py at fine 64, coarse 32, 50 steps, 20
           iterations: x0_fine, x0_coarse (and noises), hist_cold,
           hist_coarse, hist_warm, x_coarse, x_warm, to_target_cold,
           to_target_warm
  mc_*     mixing_regrid_continuation.py --small at 100 steps, 3 coarse and
           2 fine iterations: x0, noise, fv_coarse, fv_fine, f/g counts,
           j_start (the regridded state's J on the fine grid)
  m5_*     mixing512_df64_study.py --small at 60 steps, 3 iterations: x0,
           noise, fv, steps, iters, f, g
  ks_*     kdyn_sharded_optimisation.py --npts 8 --steps 20 --iters 3: x0_b,
           x0_u, hist, steps
  ms_*     mixing_sharded_optimisation.py --nx 32 --nz 16 --steps 20
           --iters 3 --s 0 (the KE objective: its Wolfe searches go on past
           the first iteration here, where the mix-norm's stop): x0, noise,
           hist, steps

Run on a CPU: python baselines/make_examples_port_ref.py   (a few minutes)
"""

import contextlib
import io
import json
import math
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
os.environ.setdefault("SMO_OP_CACHE", "0")   # no operator cache on disk
os.environ.setdefault("SMO_JAX_CACHE", tempfile.mkdtemp(prefix="smo_jax_cache_"))
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))

# shared in-process CPU force + x64 (utils/platform.py)
from spheremanopt_tpu.utils.platform import apply_platform  # noqa: E402

apply_platform("cpu", x64=True)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spheremanopt_tpu.optim.jit_driver import jit_optimise_on_multi_sphere  # noqa: E402
from spheremanopt_tpu.optim.optimiser import optimise_on_multi_sphere  # noqa: E402
from spheremanopt_tpu.optim.rtr import optimise_rtr  # noqa: E402
from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig, KinematicDynamo  # noqa: E402
from spheremanopt_tpu.problems.optimal_mixing import MixingConfig, OptimalMixing  # noqa: E402
from spheremanopt_tpu.problems.swift_hohenberg import SH23Config, SwiftHohenberg  # noqa: E402
from spheremanopt_tpu.utils.regrid import regrid_state  # noqa: E402

OUT = os.path.join(HERE, "examples_port_ref.npz")
F64 = jnp.float64


def a(x):
    return np.asarray(x, np.float64)


def pad(rows):
    """Ragged histories as one NaN-padded 2-D array."""
    n = max([len(r) for r in rows] + [1])
    out = np.full((len(rows), n), np.nan)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def hist(r):
    k = int(r.iterations)
    return a(r.function_values)[:k], k


def sh23_noise(p, seed):
    return a(jax.random.normal(jax.random.PRNGKey(seed), (p.basis.n_grid,), F64))


def kdyn_noise(p, seed):
    kb, ku = jax.random.split(jax.random.PRNGKey(seed))
    return [a(jax.random.normal(k, (p.mg,) * 3, F64)) for k in (kb, ku)]


def mixing_noise(p, seed):
    return a(jax.random.normal(jax.random.PRNGKey(seed), (p.mgx, p.mgz), F64))


def run_main(module, argv):
    """The JAX example's `main` with `argv`; (its return value, stdout)."""
    mod = __import__(module)
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [module + ".py"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            ret = mod.main()
    finally:
        sys.argv = old
    return ret, buf.getvalue()


def critical_seed(out):
    npts, dt, t_final, bis, iters, lo, hi = 48, 0.05, 10.0, 3, 20, 0.005, 0.08
    p = SwiftHohenberg(SH23Config(npts=npts, dt=dt, n_iters=int(round(t_final / dt)),
                                  dtype="float64"))
    x0 = p.generate_ic(seed=42, e0=1.0)
    j_tiny = -float(p.objective([x0[0] * jnp.sqrt(1e-8)]))
    opt = jit_optimise_on_multi_sphere(
        lambda xs: p._obj_and_grad(xs), p.inner_product, [1.0],
        max_iters=iters, alpha0=float(np.pi), cg=True)
    probes = []

    def optimal_J(e0):
        r = opt(x0, radii_dyn=[jnp.asarray(e0)])
        h, k = hist(r)
        probes.append((e0, float(h[max(k - 1, 0)] if k else a(r.function_values)[0]), k, h))
        return probes[-1][1]

    j_lo, j_hi = optimal_J(lo), optimal_J(hi)
    threshold = 10.0 * max(j_lo, j_tiny * (lo / 1e-8))
    assert j_hi > threshold > j_lo
    trig = []
    for _ in range(bis):
        mid = 0.5 * (lo + hi)
        t = optimal_J(mid) > threshold
        trig.append(t)
        lo, hi = (lo, mid) if t else (mid, hi)
    ret, _ = run_main("sh23_critical_seed", [
        "--platform", "cpu", "--npts", str(npts), "--t-final", str(t_final),
        "--bisections", str(bis), "--max-iters", str(iters)])
    assert ret["critical_seed_energy"] == 0.5 * (lo + hi), ret
    assert [h["triggered"] for h in ret["bisections"]] == trig
    for h, pr in zip(ret["bisections"], probes[2:]):
        assert h["E0"] == pr[0] and abs(h["J_opt"] - pr[1]) <= 1e-12 * abs(pr[1])
    out.update(seed_x0=a(x0[0]), seed_noise=sh23_noise(p, 42), seed_j_tiny=j_tiny,
               seed_threshold=threshold, seed_e0=np.array([q[0] for q in probes]),
               seed_j=np.array([q[1] for q in probes]),
               seed_iters=np.array([q[2] for q in probes]),
               seed_hist=pad([q[3] for q in probes]), seed_triggered=np.array(trig),
               seed_ec=0.5 * (lo + hi), seed_bracket=np.array([lo, hi]))
    print(f"critical seed: E_c {0.5 * (lo + hi)!r}, probes "
          f"{[(q[0], q[1], q[2]) for q in probes]}", flush=True)


def critical_rm(out):
    npts, steps, dt, iters, bis, lo0, hi0 = 8, 50, 5e-4, 3, 2, 0.5, 16.0
    p = KinematicDynamo(KDynConfig(npts=npts, n_iters=steps, dt=dt, dtype="float64"))
    fg, make_ops = p.objective_and_gradient_rm
    opt = jit_optimise_on_multi_sphere(
        fg, p.inner_product, [1.0, 1.0], max_iters=iters, alpha0=100.0, cg=True,
        line_search="wolfe", err_tol=1e-12)
    x0 = [jnp.asarray(x) for x in p.generate_ic(seed=42)]
    probes = []

    def j_opt(rm):
        res = opt(x0, aux=make_ops(rm))
        h, k = hist(res)
        j = float(np.nanmax(a(res.function_values)))
        probes.append((rm, j, k, h))
        return j

    j_lo, j_hi = j_opt(lo0), j_opt(hi0)
    assert j_lo < 1.0 < j_hi
    lo, hi = math.log2(lo0), math.log2(hi0)
    growth = []
    for _ in range(bis):
        mid = 0.5 * (lo + hi)
        g = j_opt(2.0 ** mid) > 1.0
        growth.append(g)
        lo, hi = (lo, mid) if g else (mid, hi)
    rm_c = 2.0 ** (0.5 * (lo + hi))
    _, text = run_main("kdyn_critical_rm", [
        "--platform", "cpu", "--npts", str(npts), "--steps", str(steps),
        "--iters", str(iters), "--bisections", str(bis)])
    ret = json.loads(text[text.index("\n{") + 1:])
    assert ret["rm_c"] == round(rm_c, 5) and ret["n_probes"] == len(probes), ret
    for h, pr in zip(ret["probes"], probes):
        assert h["rm"] == pr[0] and abs(h["J_opt"] - pr[1]) <= 1e-12 * abs(pr[1])
    nb, nu = kdyn_noise(p, 42)
    out.update(rm_x0_b=a(x0[0]), rm_x0_u=a(x0[1]), rm_noise_b=nb, rm_noise_u=nu,
               rm_rm=np.array([q[0] for q in probes]), rm_j=np.array([q[1] for q in probes]),
               rm_iters=np.array([q[2] for q in probes]), rm_hist=pad([q[3] for q in probes]),
               rm_growth=np.array([True if q[1] > 1.0 else False for q in probes]),
               rm_rm_c=rm_c, rm_bracket=np.array([2.0 ** lo, 2.0 ** hi]))
    print(f"critical Rm: rm_c {rm_c!r}, probes {[(q[0], q[1], q[2]) for q in probes]}",
          flush=True)


def lbfgs_vs_cg(out):
    cases = {"sh23": (SwiftHohenberg(SH23Config(npts=48, n_iters=50, dt=0.05,
                                                dtype="float64")), 20, float(np.pi)),
             "kdyn": (KinematicDynamo(KDynConfig(npts=8, n_iters=20, dt=5e-4,
                                                 dtype="float64")), 3, 100.0)}
    for name, (p, max_iters, alpha0) in cases.items():
        x0 = p.generate_ic(42)
        out.update({f"lb_{name}_x{i}": a(x) for i, x in enumerate(x0)})
        out[f"lb_{name}_noise"] = (sh23_noise(p, 42) if name == "sh23"
                                   else np.stack(kdyn_noise(p, 42)))
        for direction in ("cg", "lbfgs"):
            opt = jit_optimise_on_multi_sphere(
                p.objective_and_gradient, p.inner_product, p.radii, max_iters=max_iters,
                alpha0=alpha0, line_search="wolfe", direction=direction)
            h, k = hist(opt(x0))
            out[f"lb_{name}_{direction}_iters"] = k
            out[f"lb_{name}_{direction}_hist"] = h
            print(f"lbfgs_vs_cg {name} {direction}: {k} iterations, J {h.tolist()}",
                  flush=True)


def rtr_vs_cg(out):
    p = SwiftHohenberg(SH23Config(npts=32, n_iters=50, dt=0.05, dtype="float64"))
    x0 = p.generate_ic(42)
    kw = dict(err_tol=1e-6, max_iters=10, verbose=False)
    cg = optimise_on_multi_sphere(x0, p.radii, p.objective, p.gradient, p.inner_product,
                                  alpha_k=float(np.pi), line_search="wolfe", method="cg",
                                  f_and_g=p.objective_and_gradient, **kw)
    tr = optimise_rtr(x0, p.radii, p.objective, p.gradient, p.inner_product, **kw)
    out.update(rtr_x0=a(x0[0]), rtr_noise=sh23_noise(p, 42))
    for name, r in (("cg", cg), ("rtr", tr)):
        out.update({f"rtr_{name}_iters": r.iterations, f"rtr_{name}_f": r.function_evals,
                    f"rtr_{name}_g": r.gradient_evals, f"rtr_{name}_hvp": r.hvp_evals,
                    f"rtr_{name}_hist": a(r.function_values),
                    f"rtr_{name}_res": a(r.residuals[0]),
                    f"rtr_{name}_converged": bool(r.converged)})
        print(f"rtr_vs_cg {name}: {r.iterations} iterations, f {r.function_evals}, g "
              f"{r.gradient_evals}, hvp {r.hvp_evals}, converged {r.converged}",
              flush=True)


def regrid_warmstart(out):
    def make(npts):
        p = SwiftHohenberg(SH23Config(npts=npts, n_iters=50, dt=0.05, e0=0.0725,
                                      dtype="float64", method="matmul"))
        opt = jit_optimise_on_multi_sphere(
            p.objective_and_gradient, p.inner_product, p.radii, max_iters=20,
            alpha0=float(np.pi), cg=True, line_search="wolfe")
        return p, opt

    def run(opt, x):
        r = opt([jnp.asarray(np.asarray(v), F64) for v in x])
        h, _ = hist(r)
        return h, [a(v) for v in r.x_opt]

    def iters_to(jf, target):
        hit = np.nonzero(jf >= target)[0]
        return int(hit[0]) + 1 if hit.size else -1

    p_f, opt_f = make(64)
    p_c, opt_c = make(32)
    x0_f, x0_c = p_f.generate_ic(seed=42), p_c.generate_ic(seed=42)
    j_cold, _ = run(opt_f, x0_f)
    j_coarse, x_coarse = run(opt_c, x0_c)
    x_warm = regrid_state(p_f, x_coarse)
    j_warm, _ = run(opt_f, x_warm)
    target = float(j_cold[-1]) * (1.0 - 1e-3)
    out.update(ws_x0_fine=a(x0_f[0]), ws_x0_coarse=a(x0_c[0]),
               ws_noise_fine=sh23_noise(p_f, 42), ws_noise_coarse=sh23_noise(p_c, 42),
               ws_hist_cold=j_cold, ws_hist_coarse=j_coarse, ws_hist_warm=j_warm,
               ws_x_coarse=x_coarse[0], ws_x_warm=a(x_warm[0]),
               ws_to_target_cold=iters_to(j_cold, target),
               ws_to_target_warm=iters_to(j_warm, target))
    print(f"regrid warm start: cold {len(j_cold)} / warm {len(j_warm)} iterations, "
          f"to target {out['ws_to_target_cold']} / {out['ws_to_target_warm']}", flush=True)


def mixing_host(p, x0, max_iters):
    return optimise_on_multi_sphere(
        x0, p.radii, p.objective, p.gradient, p.inner_products, max_iters=max_iters,
        alpha_k=100.0, line_search="wolfe", cg=True, f_and_g=p.objective_and_gradient,
        verbose=False)


def mixing_continuation(out):
    def build(nx, nz):
        return OptimalMixing(MixingConfig(nx=nx, nz=nz, dt=5e-3, n_iters=100, s=1,
                                          dtype="float64"))

    p_c = build(64, 32)
    x0 = p_c.generate_ic(seed=42)
    rc = mixing_host(p_c, x0, 3)
    p_f = build(128, 64)
    x_warm = regrid_state(p_f, [a(v) for v in rc.x_opt])
    j_start = float(p_f.objective([jnp.asarray(v) for v in x_warm]))
    rf = mixing_host(p_f, [jnp.asarray(v) for v in x_warm], 2)
    out.update(mc_x0=a(x0[0]), mc_noise=mixing_noise(p_c, 42),
               mc_fv_coarse=a(rc.function_values), mc_fv_fine=a(rf.function_values),
               mc_f=np.array([rc.function_evals, rf.function_evals]),
               mc_g=np.array([rc.gradient_evals, rf.gradient_evals]),
               mc_iters=np.array([rc.iterations, rf.iterations]), mc_j_start=j_start)
    print(f"mixing continuation: coarse {a(rc.function_values).tolist()}, fine "
          f"{a(rf.function_values).tolist()}, J_start {j_start!r}", flush=True)


def mixing512(out):
    p = OptimalMixing(MixingConfig(nx=64, nz=32, dt=5e-3, n_iters=60, s=1,
                                   dtype="float64"))
    x0 = p.generate_ic(seed=42)
    r = mixing_host(p, x0, 3)
    out.update(m5_x0=a(x0[0]), m5_noise=mixing_noise(p, 42), m5_fv=a(r.function_values),
               m5_steps=a(r.step_sizes), m5_iters=r.iterations, m5_f=r.function_evals,
               m5_g=r.gradient_evals)
    print(f"mixing512 --small: {a(r.function_values).tolist()}", flush=True)


def kdyn_sharded(out):
    p = KinematicDynamo(KDynConfig(npts=8, n_iters=20, dt=1e-3, dtype="float64"))
    x0 = p.generate_ic(seed=3)
    opt = jit_optimise_on_multi_sphere(
        p.objective_and_gradient, p.inner_product, p.radii, max_iters=3, alpha0=100.0,
        cg=True, err_tol=1e-12, line_search="wolfe")
    r = opt(x0)
    h, k = hist(r)
    out.update(ks_x0_b=a(x0[0]), ks_x0_u=a(x0[1]), ks_hist=h,
               ks_steps=a(r.step_sizes)[:k])
    print(f"kdyn sharded: {h.tolist()}", flush=True)


def mixing_sharded(out):
    p = OptimalMixing(MixingConfig(nx=32, nz=16, n_iters=20, prep_steps=5, s=0,
                                   dtype="float64"))
    fg, ops = p.objective_and_gradient_aux
    x0 = p.generate_ic(seed=3)
    opt = jit_optimise_on_multi_sphere(
        fg, p.inner_product, p.radii, max_iters=3, alpha0=10.0, cg=True, err_tol=1e-12,
        line_search="wolfe")
    r = opt(x0, None, ops)
    h, k = hist(r)
    out.update(ms_x0=a(x0[0]), ms_noise=mixing_noise(p, 3), ms_hist=h,
               ms_steps=a(r.step_sizes)[:k])
    print(f"mixing sharded: {h.tolist()}", flush=True)


def main():
    out = {}
    for study in (critical_seed, critical_rm, lbfgs_vs_cg, rtr_vs_cg, regrid_warmstart,
                  mixing_continuation, mixing512, kdyn_sharded, mixing_sharded):
        study(out)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes, {len(out)} arrays)")


if __name__ == "__main__":
    main()
