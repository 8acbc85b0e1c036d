"""The port's streaming WAL (``repro_torch/checkpoint/wal.py``) against the
JAX package's, byte for byte: record payloads and CRC frames, segment
directories written by one package and read by the other, torn-tail
truncation on the JAX tests' cases, and ``gc_covered``.

Inputs are made from a seed with numpy and given to both sides.
"""
from __future__ import annotations

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.checkpoint import wal as jwal
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.checkpoint import wal as twal
from torch_port_helpers import assert_same


def _bf16(rng, shape):
    """The same bf16 values as a JAX-side array and a port tensor."""
    x = (rng.normal(size=shape) * 4).astype(np.float32)
    j = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return j, torch.from_numpy(j.view(np.int16).copy()).view(torch.bfloat16)


def _case(name, rng):
    """(JAX-side arrays, port-side arrays) of one record."""
    if name == "int32":
        a = rng.integers(-2**31, 2**31 - 1, (5, 3)).astype(np.int32)
        return {"x": a}, {"x": torch.from_numpy(a.copy())}
    if name == "int64":
        a = rng.integers(-2**40, 2**40, (7,)).astype(np.int64)
        s = np.asarray(41, np.int64)  # 0-d must stay 0-d
        return {"x": a, "s": s}, {"x": torch.from_numpy(a.copy()),
                                  "s": torch.tensor(41, dtype=torch.int64)}
    if name == "bf16":
        j, t = _bf16(rng, (2, 3, 4))
        return {"p": j}, {"p": t}
    if name == "empty":
        a = np.zeros((0, 3), np.int32)
        return {"e": a, "b": np.zeros((0,), bool)}, {
            "e": torch.zeros((0, 3), dtype=torch.int32),
            "b": torch.zeros((0,), dtype=torch.bool)}
    # numpy arrays go through the port's encoder too
    a = rng.integers(0, 9, (4, 4)).astype(np.int32)
    j, t = _bf16(rng, (3,))
    return ({"a": a, "f": np.arange(6, dtype=np.float32), "h": j},
            {"a": a.copy(), "f": np.arange(6, dtype=np.float32), "h": t})


CASES = ("int32", "int64", "bf16", "empty", "mixed")


@pytest.mark.parametrize("name", CASES)
def test_pack_record_and_frame_bytes_equal(name):
    rng = np.random.default_rng(CASES.index(name))
    ja, ta = _case(name, rng)
    meta = {"step": 9, "kind": 1, "base_step": -1, "prev_covered": 7}
    jp = jwal.pack_record(ja, meta)
    tp = twal.pack_record(ta, meta)
    assert jp == tp
    assert jwal.frame(jp) == twal.frame(tp)
    # and each side decodes the other's payload to the same arrays
    arrays, got_meta = twal.unpack_record(jp)
    assert got_meta == meta
    assert_same(jwal.unpack_record(tp)[0], arrays)


def _write(mod, d, records, sync_every=2, segment_bytes=1 << 30):
    w = mod.SegmentWriter(d, segment_bytes=segment_bytes)
    ends, off = [], 0
    for i, (step, arrays, meta) in enumerate(records):
        off += w.append(step, arrays, meta)
        ends.append(off)
        if (i + 1) % sync_every == 0:
            w.sync()
    w.close()
    return ends, w


def _records(side, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ja, ta = _case(CASES[i % len(CASES)], rng)
        meta = {"step": i, "kind": 0}
        out.append((i, ja if side == "jax" else ta, meta))
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_segment_directories_cross(tmp_path, writer):
    """A directory written by one package is read by the other (and the
    files are the same bytes), across a segment rotation."""
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    ej, wj = _write(jwal, dj, _records("jax", 9), segment_bytes=400)
    et, wt = _write(twal, dt, _records("torch", 9), segment_bytes=400)
    assert ej == et and wj.segments_opened == wt.segments_opened > 1
    assert (wj.fsyncs, wj.records) == (wt.fsyncs, wt.records)
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt))
    for n in names:
        with open(os.path.join(dj, n), "rb") as f, \
                open(os.path.join(dt, n), "rb") as g:
            assert f.read() == g.read(), n
    src = dj if writer == "jax" else dt
    jr, jt = jwal.read_segments(src, truncate_torn=False)
    tr, tt = twal.read_segments(src, truncate_torn=False)
    assert jt == tt == []
    assert [r[0] for r in jr] == [r[0] for r in tr] == list(range(9))
    for (_, ja, jm), (_, ta, tm) in zip(jr, tr):
        assert jm == tm
        assert_same(ja, ta)


def _tear_both(tmp_path, n, sync_every, tear):
    """Write the same n records with both writers, tear both segments the
    same way, recover with each package; returns both results."""
    out = {}
    for name, mod in (("jax", jwal), ("torch", twal)):
        d = str(tmp_path / name)
        ends, _ = _write(mod, d, _records(name, n), sync_every)
        (_, path), = mod.list_segments(d)
        tear(path, ends)
        recs, truncated = mod.read_segments(d, truncate_torn=True)
        out[name] = ([r[0] for r in recs], os.path.getsize(path),
                     [os.path.basename(p) for p in truncated], ends)
    return out


# the JAX property tests' parameters (tests/test_streaming_wal.py:119 and
# :144), as fixed cases: cut points at frame ends, inside headers and
# payloads, and past the end
@pytest.mark.parametrize("cut_at,n,sync_every", [
    (0, 1, 1), (5, 3, 1), (11, 3, 2), ("end-1", 4, 3), ("end", 5, 2),
    ("mid", 7, 1), ("frame1", 6, 3), ("frame1+13", 2, 2), (10**9, 3, 3),
])
def test_torn_tail_truncates_like_jax(tmp_path, cut_at, n, sync_every):
    def tear(path, ends):
        total = ends[-1]
        cut = {"end": total, "end-1": total - 1, "mid": total // 2,
               "frame1": ends[0], "frame1+13": ends[0] + 13}.get(cut_at,
                                                                cut_at)
        with open(path, "r+b") as f:
            f.truncate(cut % (total + 1))

    got = _tear_both(tmp_path, n, sync_every, tear)
    assert got["jax"] == got["torch"]


@pytest.mark.parametrize("garbage", [1, 3, 64])
def test_torn_tail_with_trailing_garbage_like_jax(tmp_path, garbage):
    def tear(path, ends):
        with open(path, "ab") as f:
            f.write(b"\xde\xad" * garbage)

    got = _tear_both(tmp_path, 3, 2, tear)
    assert got["jax"] == got["torch"]
    recs, size, truncated, ends = got["torch"]
    assert recs == [0, 1, 2] and size == ends[-1] and truncated


def _gc_fixture(d):
    """Snapshots, legacy npz deltas, clean and torn segments (JAX-written)."""
    tree = {"x": np.arange(4, dtype=np.int32)}
    for s in (2, 6, 10):
        jckpt.save(d, s, tree)
    for s in (3, 7, 11):
        jckpt.save_delta(d, s, {"r": np.arange(s, dtype=np.int32)},
                         {"step": s})
    for start in (3, 7, 11):
        w = jwal.SegmentWriter(d)
        for s in range(start, start + 3):
            w.append(s, {"r": np.arange(2, dtype=np.int32)}, {"step": s})
        w.close()
    (_, torn), = [x for x in jwal.list_segments(d) if x[0] == 7]
    with open(torn, "ab") as f:
        f.write(jwal.MAGIC + b"\x40\x00\x00\x00\x00")


@pytest.mark.parametrize("covered", [6, 10])
def test_gc_covered_removes_the_same_files(tmp_path, covered):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    _gc_fixture(dj)
    shutil.copytree(dj, dt)
    rj = sorted(os.path.basename(p) for p in jwal.gc_covered(dj, covered))
    rt = sorted(os.path.basename(p) for p in twal.gc_covered(dt, covered))
    assert rj == rt and rj
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    # the torn segment is left for recovery to truncate first
    assert "seg_7.log" in os.listdir(dt)


def test_group_fsync_and_delta_files_match(tmp_path):
    """The port's writer counts fsyncs and records as JAX's does, and a
    legacy npz delta written by JAX loads in the port."""
    _, wj = _write(jwal, str(tmp_path / "j"), _records("jax", 7), 3)
    _, wt = _write(twal, str(tmp_path / "t"), _records("torch", 7), 3)
    assert (wj.fsyncs, wj.records, wj.bytes_written) == \
        (wt.fsyncs, wt.records, wt.bytes_written)
    d = str(tmp_path / "npz")
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    jckpt.save_delta(d, 5, {"a": a}, {"step": 5, "kind": 2})
    arrays, meta = tckpt.load_delta(d, 5)
    assert meta == {"step": 5, "kind": 2}
    assert_same({"a": a}, arrays)
