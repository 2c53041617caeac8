"""ctypes bindings for the native asynchronous record writer
(`spheremanopt_torch/io/fastio.cpp`).

Port of the JAX package's `io/native_io.py`, with its own copy of the C++
source. The shared library is built with `g++` at first use into
`build/spheremanopt_torch/fastio-<hash of the source and flags>/` beside
the package (git-ignored), so a changed source rebuilds and an unchanged
one is reused. There is no fallback: a missing compiler, a failed build
or a library that does not load raises `NativeIOUnavailable`.

  * AsyncRecordWriter: named-record writer whose `write` returns at once
    while a C++ thread drains the records to disk (per-iteration
    checkpoints, trajectory snapshots)
  * read_records: a Python reader with CRC verification

The "SMO1" container is byte for byte the JAX package's, so either
package reads the other's records.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from spheremanopt_torch.io.checkpoint import to_numpy

SRC = Path(__file__).resolve().with_name("fastio.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "spheremanopt_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_MAGIC = b"SMO1\x00\x00\x00\x01"


class NativeIOUnavailable(RuntimeError):
    pass


_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / f"fastio-{h.hexdigest()[:16]}" / "libfastio.so"


def compiler_version() -> str:
    """The first line of `g++ --version`."""
    try:
        out = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        raise NativeIOUnavailable(f"g++ not usable: {e}") from e
    return out.splitlines()[0]


def build() -> Path:
    """Compile fastio.cpp unless the library for this source exists."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # build into a temporary directory and rename: concurrent first uses
    # never load a half-written library
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        out = os.path.join(tmp, lib.name)
        try:
            subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", out],
                           check=True, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeIOUnavailable(f"g++ not found: {e}") from e
        except subprocess.CalledProcessError as e:
            raise NativeIOUnavailable(
                f"g++ failed to build {SRC.name}:\n{e.stderr}") from e
        os.replace(out, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeIOUnavailable(f"cannot load {path}: {e}") from e
    lib.fio_open.restype = ctypes.c_void_p
    lib.fio_open.argtypes = [ctypes.c_char_p]
    lib.fio_enqueue.restype = ctypes.c_int
    lib.fio_enqueue.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_void_p, ctypes.c_int64]
    lib.fio_flush.restype = ctypes.c_int
    lib.fio_flush.argtypes = [ctypes.c_void_p]
    lib.fio_close.restype = ctypes.c_int
    lib.fio_close.argtypes = [ctypes.c_void_p]
    lib.fio_stats_records.restype = ctypes.c_int64
    lib.fio_stats_records.argtypes = [ctypes.c_void_p]
    lib.fio_stats_bytes.restype = ctypes.c_int64
    lib.fio_stats_bytes.argtypes = [ctypes.c_void_p]
    lib.fio_crc32.restype = ctypes.c_uint32
    lib.fio_crc32.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.fio_error.restype = ctypes.c_int
    lib.fio_error.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class AsyncRecordWriter:
    """Named-array record writer; `write` returns at once and a C++
    thread drains to disk. Arrays (numpy, or tensors on any device,
    copied to the host) are serialised as '<name>|<dtype>|<shape csv>'
    headers with raw payloads."""

    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        self._handle = lib.fio_open(path.encode())
        if not self._handle:
            raise NativeIOUnavailable(f"fio_open failed for {path}")
        self.path = path

    def write(self, name: str, array) -> None:
        if "|" in name:
            raise ValueError(f"record name must not contain '|': {name!r}")
        a = np.ascontiguousarray(to_numpy(array))
        # byte-order-free dtypes (bool, int8, ...) have .str '|b1' etc.:
        # the leading '|' would break the three-field tag, so strip it
        dt = a.dtype.str.lstrip("|")
        tag = f"{name}|{dt}|{','.join(map(str, a.shape))}"
        rc = self._lib.fio_enqueue(
            self._handle, tag.encode(), a.ctypes.data_as(ctypes.c_void_p),
            a.nbytes,
        )
        if rc != 0:
            raise IOError(f"fio_enqueue failed for {name} "
                          "(writer error or queue cap exceeded)")

    def flush(self) -> None:
        """Block until every enqueued record reached the OS. Raises if any
        write failed (disk full, EIO): a return is the durability signal."""
        if self._lib.fio_flush(self._handle) != 0:
            raise IOError(
                f"native writer reported an I/O failure for {self.path} "
                "(disk full or write error); records since the failure "
                "were NOT persisted")

    @property
    def stats(self):
        return {
            "records": self._lib.fio_stats_records(self._handle),
            "bytes": self._lib.fio_stats_bytes(self._handle),
        }

    def close(self) -> None:
        if self._handle:
            self._lib.fio_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, verify_crc: bool = True) -> Dict[str, np.ndarray]:
    """All records; a later record of the same name wins (a rewritten
    progress checkpoint reads back its newest state). A truncated tail (a
    crash mid-write) is ignored; a CRC mismatch raises."""
    lib = _load()
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise IOError(f"{path}: bad magic")
        while True:
            head = f.read(4)
            if len(head) < 4:
                break
            (name_len,) = np.frombuffer(head, np.uint32)
            tag_b = f.read(int(name_len))
            len_b = f.read(8)
            crc_b = f.read(4)
            if len(tag_b) < int(name_len) or len(len_b) < 8 or len(crc_b) < 4:
                break   # truncated header
            tag = tag_b.decode(errors="replace")
            (payload_len,) = np.frombuffer(len_b, np.uint64)
            (crc,) = np.frombuffer(crc_b, np.uint32)
            payload = f.read(int(payload_len))
            if len(payload) < int(payload_len):
                break   # truncated payload
            if verify_crc:
                got = lib.fio_crc32(payload, len(payload))
                if np.uint32(got) != crc:
                    raise IOError(f"{path}: CRC mismatch for record {tag}")
            # rsplit: an older file's dtype field may itself start with '|';
            # the name holds none
            name, rest = tag.split("|", 1)
            dtype, shape = rest.rsplit("|", 1)
            shape = tuple(int(s) for s in shape.split(",") if s)
            # a writable copy (frombuffer over bytes is read-only)
            out[name] = (np.frombuffer(payload, np.dtype(dtype))
                         .reshape(shape).copy())
    return out
