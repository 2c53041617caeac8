"""Host loops over device-resident state, each step replayed as a CUDA
graph on the card.

The JAX package compiles a whole optimisation into one `lax.while_loop`
(`optim/jit_driver.py`, `optim/jit_rtr.py`). Here the loop body is cut
into a few named steps, each a function `step(S) -> dict` from the state
dict `S` (tensors, or lists of tensors) to the entries it replaces. Every
step also writes `S["flag"]`, a 0-dim integer tensor, and the host loop
reads that one word after each step to choose the next: for a line-search
trial, whether the search is over; for an iteration's commit, whether the
optimisation is still active.

On the CPU, and on the card with `graphs=False`, a step runs eagerly.
On the card the first call for a given set of shapes runs every step
once eagerly on a side stream (the warm-up: it builds the kernels, fills
the wrappers' cached card queries and sets the kernels' attributes, and
creates the state's buffers), then captures each step in a CUDA graph
whose reads and writes are those static buffers; later calls copy their
inputs into the buffers and replay. The graphs share one memory pool:
they run one after another on one stream, and nothing a graph allocates
outlives its replay. Python's cyclic garbage collector is off while a
step is captured: a collection there could free another graph's memory
in the middle of the capture, which invalidates it. A capture or replay
that fails raises; there is no eager fallback on the card.

The kernel wrappers count a launch on the host when they launch, which
under capture is once, at capture time. So a capture's counts are taken
back, and each replay adds the launches its graph holds
(`ops/cuda/*.LAUNCHES`).
"""

from __future__ import annotations

import gc
from collections import Counter
from typing import Callable, Dict, Sequence

import torch

from spheremanopt_torch.ops.cuda import fused_two_matrix as _fk
from spheremanopt_torch.ops.cuda import kdyn_step as _kd

LAUNCH_TABLES = (_fk.LAUNCHES, _kd.LAUNCHES)


def _snapshot():
    return [dict(t) for t in LAUNCH_TABLES]


def _restore(snap):
    for t, s in zip(LAUNCH_TABLES, snap):
        t.update(s)


def _own(v):
    """A buffer of the state: a copy of `v` that no step output aliases."""
    if isinstance(v, (list, tuple)):
        return [t.clone() for t in v]
    return v.clone()


def _copy_into(dst, src):
    if isinstance(dst, list):
        for d, s in zip(dst, src):
            d.copy_(s)
    else:
        dst.copy_(src)


class _Const:
    def __init__(self, value):
        self.value = value


def tree_flatten(tree):
    """(leaves, rebuild) of nested lists, tuples and dicts of tensors:
    `rebuild(new_leaves)` is `tree` with its tensors replaced in order."""
    leaves = []

    def walk(t):
        if isinstance(t, (list, tuple)):
            return type(t)(walk(x) for x in t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            return len(leaves) - 1
        return _Const(t)

    spec = walk(tree)

    def rebuild(new_leaves, s=spec):
        if isinstance(s, (list, tuple)):
            return type(s)(rebuild(new_leaves, x) for x in s)
        if isinstance(s, dict):
            return {k: rebuild(new_leaves, v) for k, v in s.items()}
        if isinstance(s, _Const):
            return s.value
        return new_leaves[s]

    return leaves, rebuild


class GraphLoop:
    """Named steps over one state dict, run eagerly or as CUDA graphs.

    `steps` maps a name to `step(S) -> dict`; `order` is the order of a
    warm-up pass through the steps (each name once), which must leave
    every entry of the state created. `graphs` selects graph replay and
    requires state on a CUDA device.
    """

    def __init__(self, steps: Dict[str, Callable], order: Sequence[str],
                 graphs: bool):
        self.steps, self.order, self.graphs = steps, tuple(order), graphs
        self.S: dict = {}
        self._g = {}
        self._launches = {}
        self.replays = Counter()   # steps run, by name, since the last reset

    # -- eager ---------------------------------------------------------------

    def _write(self, out):
        """Copy a step's outputs into the state's buffers. An output that
        is itself a buffer of the state (an entry passed on under another
        name) is copied first, so no buffer is read after it was
        overwritten."""
        bufs = {id(t) for v in self.S.values()
                for t in (v if isinstance(v, list) else [v])}

        def safe(v):
            if isinstance(v, list):
                return [t.clone() if id(t) in bufs else t for t in v]
            return v.clone() if id(v) in bufs else v

        out = {k: safe(v) for k, v in out.items() if v is not self.S.get(k)}
        for k, v in out.items():
            if k in self.S:
                _copy_into(self.S[k], v)
            else:
                self.S[k] = _own(v)

    def _eager(self, name):
        out = self.steps[name](self.S)
        if self.graphs:
            self._write(out)
        else:
            self.S.update(out)

    # -- graphs --------------------------------------------------------------

    def build(self):
        """Warm up on a side stream from the inputs in the state, then
        capture every step."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for name in self.order:
                self._eager(name)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        pool = None
        for name in self.order:
            g = torch.cuda.CUDAGraph()
            before = _snapshot()
            gc.collect()
            gc.disable()
            try:
                with torch.cuda.graph(g, pool=pool):
                    self._write(self.steps[name](self.S))
            except Exception as e:
                _restore(before)
                raise RuntimeError(
                    f"CUDA graph capture of the step {name!r} failed (no eager "
                    f"fallback on the card): {e}") from e
            finally:
                gc.enable()
            after = _snapshot()
            self._launches[name] = [
                {k: a[k] - b[k] for k in a if a[k] != b[k]}
                for a, b in zip(after, before)]
            _restore(before)
            self._g[name] = g
            pool = g.pool()
        self._flag_host = torch.zeros((), dtype=torch.int64, pin_memory=True)
        self._event = torch.cuda.Event()

    def run(self, name) -> int:
        """Run one step; returns the flag it wrote."""
        self.replays[name] += 1
        if not self.graphs:
            self._eager(name)
            return int(self.S["flag"])
        self._g[name].replay()
        for table, delta in zip(LAUNCH_TABLES, self._launches[name]):
            for k, d in delta.items():
                table[k] += d
        self._flag_host.copy_(self.S["flag"], non_blocking=True)
        self._event.record()
        self._event.synchronize()
        return int(self._flag_host)

    def graph_launches(self, name) -> dict:
        """Kernel launches that one replay of step `name` holds."""
        out = {}
        for delta in self._launches.get(name, ()):
            out.update(delta)
        return out


def load_inputs(S, x0, radii, aux_leaves):
    """Write one call's inputs into the state: the starting point, the
    radii in x0's dtype (each a 0-dim tensor, or over rows an (R,) tensor
    of per-row radii), and the aux operands."""
    like = x0[0]
    vals = {
        "x0": x0,
        "radii": [torch.as_tensor(r, dtype=like.dtype, device=like.device)
                  for r in radii],
        "aux": list(aux_leaves),
    }
    for k, v in vals.items():
        if k in S:
            for d, src in zip(S[k], v):
                d.copy_(src)
        else:
            S[k] = [t.clone() for t in v]


def row_radii(radii, radii_rows, n_rows):
    """Per-sphere (R,) radii of a sweep: the columns of `radii_rows` (R,
    n_spheres), or each static radius repeated R times."""
    if radii_rows is None:
        return [torch.full((n_rows,), float(r), dtype=torch.float64) for r in radii]
    rr = torch.as_tensor(radii_rows, dtype=torch.float64)
    if rr.shape != (n_rows, len(radii)):
        raise ValueError(f"radii_rows must be ({n_rows}, {len(radii)}), got "
                         f"{tuple(rr.shape)}")
    return list(rr.unbind(1))


class DeviceOptimiser:
    """`optimise(x0_list, radii_dyn=None, aux=None)` of a device loop, and
    `optimise.sweep(x0_rows, radii_rows=None, aux=None)` over rows.

    `make_steps(aux_obj, batched)` builds the loop's steps for one aux
    operand object (with `batched`, over rows), `drive(loop)` runs them
    from the start, `result(S)` reads the result from the state. A DTensor
    x0 is gathered and comes back as a DTensor x_opt. On the
    card (unless `graphs=False`) the first call for a given set of shapes
    (a sweep's include its R) builds and captures a `GraphLoop` (kept, and
    replayed by later calls with those shapes); otherwise each call runs
    the steps eagerly. `last_loop` is the loop of the last call (steps
    run, launches a replay holds), `last_replays` the steps that call ran
    (over all its rows).

    `native_rows` says that the problem has batched forms (the loop's
    steps over rows; with SH23's and SHB23's `cuda` rows each step
    launches the row kernels once for all rows, captured in the step's
    graph as the one-row kernels are); without them a sweep runs its rows
    one after another on the unbatched loop, each row exactly its
    unbatched run.
    """

    def __init__(self, make_steps, order, drive, result, radii, graphs=None,
                 native_rows=False):
        self.make_steps, self.order = make_steps, tuple(order)
        self.drive, self.result = drive, result
        self.radii, self.graphs = tuple(radii), graphs
        self.native_rows = native_rows
        self.loops = {}
        self.last_loop = None
        self.last_replays = {}

    def __call__(self, x0_list, radii_dyn=None, aux=None):
        rr = self.radii if radii_dyn is None else list(radii_dyn)
        self.last_replays = {}
        return self._run(x0_list, rr, aux, False)

    def sweep(self, x0_rows, radii_rows=None, aux=None):
        """R optimisations: each x0 tensor is (R, ...), the result's fields
        carry the row axis. The aux operand is one object shared by every
        row."""
        x0 = [torch.as_tensor(x) for x in x0_rows]
        n_rows = x0[0].shape[0]
        rr = row_radii(self.radii, radii_rows, n_rows)
        self.last_replays = {}
        if self.native_rows:
            return self._run(x0, rr, aux, True)
        outs = [self._run([x[i] for x in x0], [float(r[i]) for r in rr], aux, False)
                for i in range(n_rows)]
        return type(outs[0])(*(
            [torch.stack(c) for c in zip(*vals)] if isinstance(vals[0], list)
            else torch.stack(vals) for vals in zip(*outs)))

    def _run(self, x0_list, rr, aux, batched):
        from spheremanopt_torch.parallel.sharded import Layout

        layout = Layout.of(x0_list)
        if layout is not None:
            # DTensor state: gathered once, the loop run whole on every
            # rank, x_opt cut back to x0's placements (parallel/sharded.py)
            if batched:
                raise ValueError("sweep: rows of DTensor state are not supported")
            out = self._run(layout.gather(x0_list), rr, aux, False)
            return out._replace(x_opt=layout.shard(out.x_opt))
        x0 = [torch.as_tensor(x) for x in x0_list]
        leaves, rebuild = tree_flatten(aux)
        on_card = x0[0].device.type == "cuda"
        use_graphs = on_card if self.graphs is None else bool(self.graphs)
        if use_graphs and not on_card:
            raise ValueError("graphs=True needs the state on a CUDA device")
        if use_graphs:
            key = (tuple((tuple(x.shape), x.dtype, x.device) for x in x0),
                   tuple((tuple(a.shape), a.dtype, a.device) for a in leaves))
            if batched:
                key = ("rows",) + key
            L = self.loops.get(key)
            if L is None:
                L = GraphLoop(None, self.order, graphs=True)
                load_inputs(L.S, x0, rr, leaves)
                L.steps = self.make_steps(None if aux is None
                                          else rebuild(L.S["aux"]), batched)
                L.build()
                self.loops[key] = L
            load_inputs(L.S, x0, rr, leaves)
        else:
            L = GraphLoop(self.make_steps(aux, batched), self.order, graphs=False)
            load_inputs(L.S, x0, rr, [])
        L.replays.clear()
        self.drive(L)
        self.last_loop = L
        for k, v in L.replays.items():
            self.last_replays[k] = self.last_replays.get(k, 0) + v
        return self.result(L.S)
