"""Warm optimisation server: device loops kept on their CUDA graphs,
answering requests over a Unix socket.

The port of the JAX package's `serve.py`. A long-running process holds
device-resident optimisation loops (`optim/jit_driver.py`), keyed by
problem, config and driver. On the card the first call of a loop for a
set of shapes warms its steps up and captures them as CUDA graphs
(`optim/graph_loop.py`); every later request with those shapes replays
them, so a request after the first runs without the warm-up and capture.

Protocol: newline-delimited JSON, one object per line, one reply per
request.

  {"cmd": "optimise", "problem": "sh23", "seed": 3,
   "config": {"npts": 256, "n_iters": 1000},
   "driver": {"max_iters": 20, "line_search": "wolfe", "cg": true},
   "save": "/path/out.npz"}          # optional: persist x_opt + series
    -> {"ok": true, "J": [...], "residuals": [...], "step_sizes": [...],
        "iterations": n, "wall_s": ..., "cache_hit": bool}

  {"cmd": "sweep", "problem": "sh23", "seeds": [1,2,3],
   "e0": [0.02, 0.05, 0.08],          # optional per-point first-sphere
   "config": {...}, "driver": {...}}  # radius
    -> per-point result rows from `DeviceOptimiser.sweep`. Where the
       problem has native rows (`problems.base.row_forms`: PCA, SH23
       matmul / fft, SHB23 matmul, mixing, and SH23 / SHB23 `cuda` at
       the row kernels' widths, whose sweeps step every row in one launch
       of each row kernel), ONE batched device loop over rows: the rows'
       states carry a leading axis, each row makes its own run's
       decisions, mixing's operator stacks are one operand shared by
       every row. Elsewhere (KDyn, the continuous adjoints, `cuda` at
       other widths) the rows run one after another on the unbatched
       loop, each bitwise its own `optimise`.

  {"cmd": "status"}   -> uptime, request count, cached loop keys, and
                         live occupancy: {"busy": {...}|null,
                         "queued": n}, answered at once even while a
                         long sweep runs
  {"cmd": "shutdown"} -> stops the server loop

Concurrency: connections are accepted on a threaded server, so a status
client is never blocked behind a long compute; compute requests
(optimise, sweep) are serialised through one worker lock and run FIFO on
one stream, since the loops' graphs share their buffers.

Device: `--device cuda` (the default) raises when no GPU is found, and
the service never drops to the CPU by itself; `--device cpu` asks for
it. The initial conditions come from each problem's `generate_ic(seed)`,
whose torch generator draws other numbers than the JAX package's from
the same seed.

Start:  python -m spheremanopt_torch.serve --socket /tmp/smo.sock --device cuda
Client: spheremanopt_torch.serve.request(path, {...}) -> dict
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import socketserver
import threading
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ["OptimisationService", "request", "serve", "main"]


def _make_problem(name: str, config: Dict[str, Any], device):
    """Problem factory from plain JSON-able config dicts, on `device`."""
    config = dict(config or {})
    if name == "pca":
        from spheremanopt_torch.problems.pca import PCAProblem, random_spd_matrix

        dim = int(config.pop("dim", 100))
        seed = int(config.pop("matrix_seed", 0))
        if config:
            raise ValueError(f"unknown pca config keys: {sorted(config)}")
        return PCAProblem(random_spd_matrix(dim, seed=seed), device=device)
    if name == "sh23":
        from spheremanopt_torch.problems.swift_hohenberg import (
            SH23Config, SwiftHohenberg)

        return SwiftHohenberg(SH23Config(**config), device=device)
    if name == "shb23":
        from spheremanopt_torch.problems.swift_hohenberg_bounded import (
            SHB23Config, SwiftHohenbergBounded)

        return SwiftHohenbergBounded(SHB23Config(**config), device=device)
    if name == "kdyn":
        from spheremanopt_torch.problems.kinematic_dynamo import (
            KDynConfig, KinematicDynamo)

        return KinematicDynamo(KDynConfig(**config), device=device)
    if name == "mixing":
        from spheremanopt_torch.problems.optimal_mixing import (
            MixingConfig, OptimalMixing)

        return OptimalMixing(MixingConfig(**config), device=device)
    raise ValueError(f"unknown problem {name!r}")


class OptimisationService:
    """Request handler and loop cache (transport-agnostic: tests can call
    `handle` directly; the socket server wraps it). Every problem and
    loop lives on `device`."""

    def __init__(self, device="cuda"):
        from spheremanopt_torch.problems.base import resolve_device

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            from spheremanopt_torch.run import set_precision

            set_precision()
        self._cache: Dict[str, Tuple[Any, Any, Any]] = {}
        self._t0 = time.time()
        self._requests = 0
        self._hits = 0
        # compute serialisation: one worker at a time drives the loops;
        # status/shutdown answer without this lock
        self._work_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._busy: Dict[str, Any] | None = None
        self._queued = 0

    # -- loop cache --------------------------------------------------------

    def _key(self, kind: str, name: str, config: dict, driver: dict,
             batch: int = 0) -> str:
        return json.dumps({"kind": kind, "problem": name,
                           "config": config or {}, "driver": driver or {},
                           "batch": batch}, sort_keys=True)

    def _get_optimiser(self, name: str, config: dict, driver: dict):
        """(problem, DeviceOptimiser, aux, cache_hit)"""
        from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
        from spheremanopt_torch.problems.base import row_forms

        key = self._key("optimise", name, config, driver)
        with self._state_lock:
            hit = self._cache.get(key)
            if hit is not None:
                self._hits += 1
        if hit is not None:
            return (*hit, True)
        p = _make_problem(name, config, self.device)
        pair = getattr(p, "objective_and_gradient_aux", None)
        if pair is not None and pair[0] is not None:
            fg, aux = pair  # mixing: operand stacks; kdyn df64: {} and an f32 J
            f = p.objective_ops
        elif hasattr(p, "objective_and_gradient"):
            fg, aux, f = p.objective_and_gradient, None, p.objective
        else:  # objective/gradient-only problems (pca)
            fg, aux, f = (lambda xs: (p.objective(xs), p.gradient(xs))), None, p.objective
        radii = getattr(p, "radii", [1.0])  # pca: unit sphere
        opt = jit_optimise_on_multi_sphere(
            fg, p.inner_product, radii, f=f,
            rows=row_forms(p, aux=aux is not None), **(driver or {}))
        with self._state_lock:
            self._cache[key] = (p, opt, aux)
        return p, opt, aux, False

    # -- handlers ----------------------------------------------------------

    def handle(self, req: Dict[str, Any]) -> Dict[str, Any]:
        with self._state_lock:
            self._requests += 1
        try:
            cmd = req.get("cmd")
            if cmd == "status":
                # snapshot everything under the lock: a compute thread may
                # be inserting a cache entry right now
                with self._state_lock:
                    busy = dict(self._busy) if self._busy else None
                    queued = self._queued
                    requests = self._requests
                    hits = self._hits
                    executables = sorted(self._cache)
                return {"ok": True, "uptime_s": round(time.time() - self._t0, 3),
                        "requests": requests,
                        "cache_hits": hits,
                        "busy": busy, "queued": queued,
                        "executables": executables}
            if cmd == "shutdown":
                return {"ok": True, "shutdown": True}
            if cmd in ("optimise", "sweep"):
                return self._run_serialised(cmd, req)
            return {"ok": False, "error": f"unknown cmd {cmd!r}"}
        except Exception as e:  # noqa: BLE001 — a server must not die
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def _run_serialised(self, cmd: str, req: Dict[str, Any]):
        """FIFO-queue a compute request behind the single worker lock; a
        concurrent status request sees it under 'queued' until it starts,
        then under 'busy'."""
        with self._state_lock:
            self._queued += 1
        acquired = False
        try:
            self._work_lock.acquire()
            acquired = True
            with self._state_lock:
                self._queued -= 1
                self._busy = {"cmd": cmd,
                              "problem": req.get("problem"),
                              "since_s": round(time.time() - self._t0, 3)}
            try:
                return (self._optimise(req) if cmd == "optimise"
                        else self._sweep(req))
            finally:
                with self._state_lock:
                    self._busy = None
        finally:
            if acquired:
                self._work_lock.release()
            else:  # interrupted before the lock: undo the queue count
                with self._state_lock:
                    self._queued -= 1

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _result_row(res):
        n = int(res.iterations)
        return {
            "J": [float(v) for v in res.function_values.cpu().numpy()[:n]],
            "residuals": res.residuals.cpu().numpy()[:n].tolist(),
            "step_sizes": [float(v) for v in res.step_sizes.cpu().numpy()[:n]],
            "iterations": n,
        }

    def _initial_condition(self, p, seed, e0=None):
        if e0 is not None:
            return p.generate_ic(seed=seed, e0=e0)
        if hasattr(p, "generate_ic"):
            return p.generate_ic(seed=seed)
        # pca: random start, unit sphere
        x = np.random.RandomState(seed).rand(p.m.shape[0])
        return [torch.as_tensor(x, dtype=p.m.dtype, device=self.device)]

    def _optimise(self, req):
        name = req["problem"]
        p, opt, aux, hit = self._get_optimiser(
            name, req.get("config"), req.get("driver"))
        x0 = self._initial_condition(p, int(req.get("seed", 42)))
        self._sync()
        t0 = time.perf_counter()
        res = opt(list(x0), aux=aux) if aux is not None else opt(list(x0))
        self._sync()
        wall = time.perf_counter() - t0
        out = {"ok": True, "cache_hit": hit, "wall_s": round(wall, 6)}
        out.update(self._result_row(res))
        if req.get("save"):
            path = req["save"]
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            np.savez(path,
                     **{f"x_opt_{i}": x.cpu().numpy()
                        for i, x in enumerate(res.x_opt)},
                     function_values=res.function_values.cpu().numpy(),
                     residuals=res.residuals.cpu().numpy(),
                     step_sizes=res.step_sizes.cpu().numpy(),
                     iterations=res.iterations.cpu().numpy())
            out["saved"] = path
        return out

    def _sweep(self, req):
        name = req["problem"]
        seeds = [int(s) for s in req["seeds"]]
        B = len(seeds)
        if B < 1:
            raise ValueError("sweep needs at least one seed")
        e0 = req.get("e0")
        if e0 is not None and len(e0) != B:
            raise ValueError("e0 must match seeds length")
        p, opt, aux, hit = self._get_optimiser(
            name, req.get("config"), req.get("driver"))
        ics = [self._initial_condition(p, s, None if e0 is None else float(e0[i]))
               for i, s in enumerate(seeds)]
        xs = [torch.stack([ic[j] for ic in ics]) for j in range(len(ics[0]))]
        base_radii = [float(r) for r in getattr(p, "radii", [1.0])]
        if e0 is not None:
            radii = [[float(e0[i])] + base_radii[1:] for i in range(B)]
        else:
            radii = [base_radii] * B

        # the sweep's key lists the batched loop among the executables; its
        # graphs live in the optimiser, keyed by the batch's shapes
        skey = self._key("sweep", name, req.get("config"),
                         req.get("driver"), batch=B)
        with self._state_lock:
            if skey in self._cache:
                self._hits += 1
            else:
                self._cache[skey] = (p, opt, aux)

        self._sync()
        t0 = time.perf_counter()
        res = opt.sweep(xs, radii, aux=aux)
        self._sync()
        wall = time.perf_counter() - t0
        fv = res.function_values.cpu().numpy()    # (B, max_iters)
        rs = res.residuals.cpu().numpy()          # (B, max_iters, n_spheres)
        ss = res.step_sizes.cpu().numpy()
        its = res.iterations.cpu().numpy()
        rows = []
        for i in range(B):
            n = int(its[i])
            row = {"J": fv[i, :n].tolist(), "residuals": rs[i, :n].tolist(),
                   "step_sizes": ss[i, :n].tolist(), "iterations": n,
                   "seed": seeds[i]}
            if e0 is not None:
                row["e0"] = float(e0[i])
            rows.append(row)
        return {"ok": True, "cache_hit": hit, "wall_s": round(wall, 6),
                "points": rows}


# -- transport -------------------------------------------------------------


def serve(socket_path: str, service: OptimisationService | None = None,
          ready_event=None, device="cuda"):
    """Run the blocking server loop on a Unix domain socket. Connections
    are threaded (a status client is answered while a sweep runs);
    compute requests serialise through the service's worker lock. Without
    a `service`, one is made on `device`."""
    service = service or OptimisationService(device)
    if os.path.exists(socket_path):
        os.unlink(socket_path)

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                line = line.strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    resp = {"ok": False, "error": f"bad json: {e}"}
                else:
                    resp = service.handle(req)
                self.wfile.write((json.dumps(resp) + "\n").encode())
                self.wfile.flush()
                if resp.get("shutdown"):
                    # stop accepting; off-thread, so as not to deadlock
                    # serve_forever's own handler
                    threading.Thread(target=self.server.shutdown,
                                     daemon=True).start()
                    return

    class Server(socketserver.ThreadingUnixStreamServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server(socket_path, Handler) as srv:
        if ready_event is not None:
            ready_event.set()
        srv.serve_forever(poll_interval=0.05)
    if os.path.exists(socket_path):
        os.unlink(socket_path)


def request(socket_path: str, obj: Dict[str, Any],
            timeout: float = 600.0) -> Dict[str, Any]:
    """One-shot client: send a request object, return the reply dict."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(socket_path)
        s.sendall((json.dumps(obj) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode())


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="spheremanopt_torch.serve",
        description="warm optimisation server (unix socket)")
    ap.add_argument("--socket", default="/tmp/spheremanopt.sock")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the problems and loops live (cuda raises "
                         "when no GPU is found)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA GPU found (use --device cpu "
                         "to run on the CPU)")
    service = OptimisationService(args.device)
    print(f"serving on {args.socket} (device={args.device})", flush=True)
    serve(args.socket, service)


if __name__ == "__main__":
    main()
