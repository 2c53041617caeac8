"""The port's native record writer (`spheremanopt_torch/io/native_io.py`
and its own copy of `fastio.cpp`) against the JAX package's.

The "SMO1" files are byte for byte the same for the same records, and
each package reads the other's; a corrupted payload fails its CRC, a
truncated tail is ignored, a later record of a name wins. Tensors are
written from any device. The library builds with g++ into
`build/spheremanopt_torch/`, never into the JAX package's
`native/build/`, and a failed build raises (no fallback).
"""

import numpy as np
import pytest
import torch

from spheremanopt_torch.io import native_io as tio
from spheremanopt_tpu.io import native_io as jio


def _records():
    rng = np.random.RandomState(0)
    return {
        "u": rng.randn(128).astype(np.float32),
        "B": (rng.randn(3, 8, 8, 5) + 1j * rng.randn(3, 8, 8, 5)).astype(np.complex64),
        "step": np.asarray([42], np.int64),
        "flags": np.asarray([True, False]),
        "x_opt_0": rng.randn(4, 6),
    }


def _write(mod, path, records):
    with mod.AsyncRecordWriter(path) as w:
        for k, v in records.items():
            w.write(k, v)
        w.flush()
        assert w.stats["records"] == len(records)


def test_files_byte_identical_and_read_by_both(tmp_path):
    recs = _records()
    tp, jp = str(tmp_path / "t.smo"), str(tmp_path / "j.smo")
    _write(tio, tp, {**recs, "u": torch.as_tensor(recs["u"])})
    _write(jio, jp, recs)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    for read in (tio.read_records, jio.read_records):
        for path in (tp, jp):
            got = read(path)
            assert sorted(got) == sorted(recs)
            for k, v in recs.items():
                assert got[k].dtype == v.dtype and np.array_equal(got[k], v)
                assert got[k].flags.writeable


def test_library_builds_into_the_port_build_dir():
    path = tio.library_path()
    assert path.parts[-3:-1] == ("spheremanopt_torch", path.parent.name)
    assert path.parent.name.startswith("fastio-") and "native" not in path.parts
    tio._load()
    assert path.exists()
    assert tio.compiler_version()


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tio, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(tio, "CXX_FLAGS",
                        tio.CXX_FLAGS + ["-include", "no_such_header.h"])
    with pytest.raises(tio.NativeIOUnavailable, match="g\\+\\+"):
        tio.build()


def test_crc_corruption_and_truncated_tail(tmp_path):
    path = str(tmp_path / "c.smo")
    _write(tio, path, {"good": np.arange(10.0), "later": np.arange(4.0)})
    raw = bytearray(open(path, "rb").read())
    # truncated tail: a header promising a payload that never came
    with open(path, "ab") as f:
        f.write(np.uint32(4).tobytes() + b"bad!" + np.uint64(1 << 30).tobytes())
    for read in (tio.read_records, jio.read_records):
        got = read(path)
        assert sorted(got) == ["good", "later"]
    raw[-3] ^= 0xFF                       # flip a byte of the last payload
    bad = str(tmp_path / "bad.smo")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="CRC"):
        tio.read_records(bad)
    assert np.array_equal(tio.read_records(bad, verify_crc=False)["good"], np.arange(10.0))
    open(bad, "wb").write(b"NOPE" + bytes(raw[4:]))
    with pytest.raises(IOError, match="magic"):
        tio.read_records(bad)


def test_last_record_wins_and_bad_names(tmp_path):
    path = str(tmp_path / "p.smo")
    with tio.AsyncRecordWriter(path) as w:
        for i in range(5):
            w.write("x_opt", np.full(16, float(i)))
        with pytest.raises(ValueError):
            w.write("a|b", np.zeros(1))
        w.flush()
    assert np.array_equal(tio.read_records(path)["x_opt"], np.full(16, 4.0))
