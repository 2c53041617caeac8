"""Content-keyed on-disk cache for f64 operator assembly (the port's own
copy of the JAX package's `utils/opcache.py`).

The mixing problem's per-kx Chebyshev-tau solution operators are
assembled and inverted once in f64 numpy at problem construction (the
reference's `build_solver()` LU factorisation step,
`FWD_Solve_Poiseuille.py:1028-1043`): about 10 s a stack at 256x128 on
one CPU core, and every construction of a problem pays it again. This
cache stores the assembled arrays keyed by a hash of every parameter
that enters the build, so a warm construction is a disk read.

Keying is conservative: any parameter change gives another key (a false
miss only costs a rebuild). Callers mix `source_digest(<builder
functions and classes>)` into the key, so editing the assembly code
invalidates its entries. `_SALT` differs from the JAX package's, so the
two packages never serve each other's entries, even from one directory.

Env:
  SMO_OP_CACHE=0       disable entirely
  SMO_OP_CACHE=<path>  cache directory (default: build/op_cache in the
                       checkout beside this package)
"""

from __future__ import annotations

import hashlib
import inspect
import os
import tempfile
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

_SALT = "torch-v1"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "op_cache"


def _cache_dir() -> Optional[str]:
    env = os.environ.get("SMO_OP_CACHE")
    if env == "0":
        return None
    if not env or env == "1":   # "1" enables the default, not a dir named ./1
        return str(DEFAULT_DIR)
    return env


def source_digest(*objs) -> str:
    """Digest of the source of the given functions or classes, for
    mixing into cache keys; objects without retrievable source digest
    their repr()."""
    h = hashlib.sha256()
    for o in objs:
        try:
            h.update(inspect.getsource(o).encode())
        except (OSError, TypeError):
            h.update(repr(o).encode())
    return h.hexdigest()[:16]


def cache_key(parts: dict) -> str:
    """Stable hash of the build parameters (sorted repr + salt)."""
    blob = _SALT + "|" + repr(sorted(parts.items()))
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def cached_arrays(parts: dict,
                  builder: Callable[[], Sequence[Optional[np.ndarray]]],
                  names: Sequence[str]) -> Tuple[Optional[np.ndarray], ...]:
    """`builder()`'s tuple of (possibly None) numpy arrays, served from or
    saved to the on-disk cache. Writes are atomic (a temporary file and a
    rename), so a crashed process leaves no torn entry; an unreadable
    entry is rebuilt and rewritten."""
    d = _cache_dir()
    if d is None:
        return tuple(builder())
    path = os.path.join(d, f"ops_{cache_key(parts)}.npz")
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                return tuple(z[n] if z[f"has_{n}"] else None for n in names)
        except Exception:
            try:
                os.unlink(path)   # torn or corrupt entry: rebuild below
            except OSError:
                pass
    arrays = tuple(builder())
    payload = {}
    for n, a in zip(names, arrays):
        payload[f"has_{n}"] = np.asarray(a is not None)
        payload[n] = np.zeros(0) if a is None else a
    try:
        os.makedirs(d, exist_ok=True)
        # the suffix must end in .npz, or np.savez appends one and the
        # rename below misses the file it wrote
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
        os.close(fd)
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    except OSError:
        pass   # best effort: a full or read-only disk must not fail a build
    return arrays
