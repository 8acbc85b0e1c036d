"""Log-structured streaming WAL: append-only CRC-framed segment files.

The port of the JAX package's ``checkpoint/wal.py``: the same frames, byte
for byte, so each package reads the other's segment directories. Instead
of one ``wal_<N>.npz`` per flush (one file create, one zip container and
one fsync per record), delta records are *appended* to a shared segment file
(``seg_<N>.log``, named by the first step it holds) as length-prefixed,
CRC-framed binary records, and durability is amortized with **group
commit** — one ``fsync`` covers every record appended since the last sync.

Frame layout (little-endian)::

    +--------+-------------+------------+------------------+
    | "OWAL" | payload_len | crc32      | payload bytes    |
    | 4 B    | u32         | u32        | payload_len B    |
    +--------+-------------+------------+------------------+

The payload is a compact custom encoding of ``(meta, arrays)`` — int meta
pairs plus raw ndarray bytes with name/dtype/shape headers. Deliberately
*not* npz: no zip central directory, no per-member headers, so streamed
bytes per record undercut ``save_delta``'s npz at identical content (the
durability bench asserts this).

Crash semantics: a torn write leaves a frame with a short or CRC-mismatched
tail. ``read_segments`` scans frames in order and, on the first invalid
frame, **truncates the file back to the last valid frame boundary** —
recovery keeps every record a group fsync covered instead of discarding the
whole flush. ``gc_covered`` reaps segments (and legacy npz records, and
superseded snapshot directories) once a newer committed full snapshot
covers them, so the durability directory stays bounded over a long run.
"""
from __future__ import annotations

import os
import shutil
import struct
import zlib

import numpy as np

from repro_torch.checkpoint import checkpointer as ckpt

MAGIC = b"OWAL"
_HEADER = struct.Struct("<4sII")  # magic | payload_len | crc32(payload)
_U32 = struct.Struct("<I")
_U16 = struct.Struct("<H")
_U8 = struct.Struct("<B")
_I64 = struct.Struct("<q")
_BF16_TAG = ckpt.BF16_TAG


# ---------------------------------------------------------------------------
# Record encoding
# ---------------------------------------------------------------------------

def pack_record(arrays: dict, meta: dict[str, int]) -> bytes:
    """Encode one WAL record payload (no frame header). ``arrays`` holds
    tensors or numpy arrays; bf16 travels as its uint16 bits under a
    ``::bf16``-tagged name."""
    out = []
    items = sorted(meta.items())
    out.append(_U32.pack(len(items)))
    for k, v in items:
        kb = k.encode()
        out.append(_U16.pack(len(kb)))
        out.append(kb)
        out.append(_I64.pack(int(v)))
    names = sorted(arrays)
    out.append(_U32.pack(len(names)))
    for name in names:
        # NOT ascontiguousarray: it silently promotes 0-d arrays to (1,)
        a, bf16 = ckpt.np_bits(arrays[name])
        if bf16:  # same uint16-view trick as checkpointer
            name = name + _BF16_TAG
        nb = name.encode()
        db = a.dtype.str.encode()
        out.append(_U16.pack(len(nb)))
        out.append(nb)
        out.append(_U8.pack(len(db)))
        out.append(db)
        out.append(_U8.pack(a.ndim))
        for d in a.shape:
            out.append(_I64.pack(d))
        raw = a.tobytes()
        out.append(_I64.pack(len(raw)))
        out.append(raw)
    return b"".join(out)


def unpack_record(payload: bytes) -> tuple[dict, dict[str, int]]:
    """Inverse of :func:`pack_record`: arrays come back as CPU tensors
    (bf16 from its bits)."""
    off = 0

    def take(n):
        nonlocal off
        b = payload[off:off + n]
        if len(b) != n:
            raise ValueError("truncated WAL record payload")
        off += n
        return b

    meta = {}
    (n_meta,) = _U32.unpack(take(4))
    for _ in range(n_meta):
        (klen,) = _U16.unpack(take(2))
        k = take(klen).decode()
        (v,) = _I64.unpack(take(8))
        meta[k] = v
    arrays = {}
    (n_arr,) = _U32.unpack(take(4))
    for _ in range(n_arr):
        (nlen,) = _U16.unpack(take(2))
        name = take(nlen).decode()
        (dlen,) = _U8.unpack(take(1))
        dtype = np.dtype(take(dlen).decode())
        (ndim,) = _U8.unpack(take(1))
        shape = tuple(_I64.unpack(take(8))[0] for _ in range(ndim))
        (rawlen,) = _I64.unpack(take(8))
        a = np.frombuffer(take(rawlen), dtype=dtype).reshape(shape)
        bf16 = name.endswith(_BF16_TAG)
        if bf16:
            name = name[: -len(_BF16_TAG)]
        arrays[name] = ckpt.from_bits(a, bf16)
    return arrays, meta


def frame(payload: bytes) -> bytes:
    """Wrap a packed payload in the MAGIC | len | crc32 frame header."""
    return _HEADER.pack(MAGIC, len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class SegmentWriter:
    """Append WAL records to ``seg_<N>.log`` files with group fsync.

    ``append`` writes a frame to the current segment *without* syncing;
    ``sync`` flushes + fsyncs once, covering every record appended since the
    previous sync (the group commit). ``rotate`` syncs and closes the
    current segment so the next append opens a fresh one — called after a
    full snapshot (so covered segments can be GC'd whole) and automatically
    when a segment exceeds ``segment_bytes``.
    """

    def __init__(self, directory: str, *, segment_bytes: int = 1 << 20):
        self.directory = directory
        self.segment_bytes = int(segment_bytes)
        self._f = None
        self.fsyncs = 0
        self.records = 0
        self.pending = 0  # records appended since the last sync
        self.bytes_written = 0
        self.segments_opened = 0

    def append(self, step: int, arrays: dict, meta: dict[str, int]) -> int:
        """Append one record covering engine ``step``; returns frame bytes."""
        if self._f is None:
            os.makedirs(self.directory, exist_ok=True)
            path = os.path.join(self.directory, f"seg_{step}.log")
            self._f = open(path, "ab")
            self.segments_opened += 1
        buf = frame(pack_record(arrays, meta))
        self._f.write(buf)
        self.records += 1
        self.pending += 1
        self.bytes_written += len(buf)
        if self._f.tell() >= self.segment_bytes:
            self.rotate()
        return len(buf)

    def sync(self) -> None:
        """Group commit: one fsync covering every pending record."""
        if self._f is not None and self.pending:
            self._f.flush()
            os.fsync(self._f.fileno())
            self.fsyncs += 1
        self.pending = 0

    def rotate(self) -> None:
        """Sync and close the current segment; the next append opens a new one."""
        if self._f is not None:
            self.sync()
            self._f.close()
            self._f = None

    close = rotate


# ---------------------------------------------------------------------------
# Reader / recovery
# ---------------------------------------------------------------------------

def list_segments(directory: str) -> list[tuple[int, str]]:
    """``(first_step, path)`` for committed segments, sorted by first step."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("seg_") and name.endswith(".log"):
            try:
                start = int(name[len("seg_"): -len(".log")])
            except ValueError:
                continue
            out.append((start, os.path.join(directory, name)))
    return sorted(out)


def scan_segment(path: str):
    """Walk one segment's frames in order.

    Returns ``(records, valid_end, torn)`` where ``records`` is a list of
    ``(step, arrays, meta)``, ``valid_end`` is the byte offset just past the
    last valid frame, and ``torn`` is True when trailing bytes past
    ``valid_end`` failed validation (short frame, bad magic, or CRC
    mismatch) — i.e. a crash interrupted an append before its group fsync.
    """
    with open(path, "rb") as f:
        data = f.read()
    records, off = [], 0
    while True:
        if off + _HEADER.size > len(data):
            break
        magic, plen, crc = _HEADER.unpack_from(data, off)
        if magic != MAGIC or off + _HEADER.size + plen > len(data):
            break
        payload = data[off + _HEADER.size: off + _HEADER.size + plen]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            break
        try:
            arrays, meta = unpack_record(payload)
        except (ValueError, TypeError):
            break
        records.append((int(meta["step"]), arrays, meta))
        off += _HEADER.size + plen
    return records, off, off != len(data)


def read_segments(directory: str, *, truncate_torn: bool = True):
    """All valid WAL records across segments, in step order.

    Returns ``(records, truncated_paths)``; when ``truncate_torn`` each torn
    segment is physically truncated back to its last valid frame boundary so
    the log is clean for subsequent appends.
    """
    records, truncated = [], []
    for _start, path in list_segments(directory):
        recs, valid_end, torn = scan_segment(path)
        if torn and truncate_torn:
            with open(path, "r+b") as f:
                f.truncate(valid_end)
            truncated.append(path)
        records.extend(recs)
    records.sort(key=lambda r: r[0])
    return records, truncated


def gc_covered(directory: str, covered_step: int) -> list[str]:
    """Reap durability artifacts fully covered by the ``covered_step`` snapshot.

    Removes legacy ``wal_<s>.npz`` records with ``s <= covered_step``,
    segments whose newest record is covered (torn segments are left for
    recovery to truncate first), and committed ``step_<m>`` snapshot
    directories older than the covering one. Returns removed paths.
    """
    removed = []
    if not os.path.isdir(directory):
        return removed
    for s in ckpt.list_deltas(directory):
        if s <= covered_step:
            path = os.path.join(directory, f"wal_{s}.npz")
            os.remove(path)
            removed.append(path)
    for _start, path in list_segments(directory):
        recs, _end, torn = scan_segment(path)
        if torn:
            continue
        if not recs or max(r[0] for r in recs) <= covered_step:
            os.remove(path)
            removed.append(path)
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                m = int(name.split("_", 1)[1])
            except ValueError:
                continue
            if m < covered_step:
                path = os.path.join(directory, name)
                shutil.rmtree(path)
                removed.append(path)
    return removed
