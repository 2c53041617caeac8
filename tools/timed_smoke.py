"""Run `chip_smoke.py` with the elapsed seconds before each line it prints
and the cost of each torch.profiler trace, to find where its time goes.

    python tools/timed_smoke.py [--only PHASES]

The arguments go to `chip_smoke.py` unchanged. Each line the smoke test
prints to its standard output starts with `<seconds since start>`
(lines printed into a captured buffer, such as an example's JSON line,
are left as they are), and each trace adds a line `<trace S s, wall W s,
N launches>`: S is the trace's whole cost (the profiled call and the
profiler's own processing), W the profiled call's wall. Its result and
exit code are the smoke test's.
"""

from __future__ import annotations

import builtins
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
T0 = time.perf_counter()
_print = builtins.print


def stamped(*args, **kwargs):
    out = kwargs.get("file") or sys.stdout
    if out is sys.__stdout__:
        args = (f"<{time.perf_counter() - T0:7.1f}>",) + args
    _print(*args, **kwargs)


def main() -> int:
    builtins.print = stamped
    import chip_smoke

    trace = chip_smoke.trace

    def timed_trace(fn):
        t = time.perf_counter()
        wall, busy, rows = trace(fn)
        print(f"<trace {time.perf_counter() - t:.1f} s, wall {wall:.2f} s, "
              f"{sum(c for _, _, c in rows)} launches>", flush=True)
        return wall, busy, rows

    chip_smoke.trace = timed_trace
    return chip_smoke.main()


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)   # as chip_smoke.py: no interpreter teardown
