"""Engine durability & crash recovery: log-structured WAL + NVM snapshots.

The port of the JAX package's ``fault/recovery.py``, writing and reading
the same directories. ORCA's fourth component moves accelerator state
adaptively over the link into a DRAM+NVM server memory system; this
module models that NVM tier with the atomic-rename checkpointer plus a
**log-structured streaming WAL** (``checkpoint.wal``) and gives the
request engines crash consistency:

* :class:`DurabilityManager` — periodic flushes of an engine state through
  the checkpointer's one-outstanding worker thread. The driver side of
  ``flush`` only copies the state to the host — synchronously, into
  buffers the copy owns, because the port's TX and KVS commits and the
  paged pool write the device state IN PLACE — and the delta diff, the
  full-vs-delta decision and the writes all run **on the worker**,
  overlapped with the engine step. Between full snapshots
  (``step_N.tmp``→rename protocol) the WAL-delta modes *append* records
  to a shared ``seg_<N>.log`` segment — CRC-framed, group-fsynced (one
  fsync per ``group_records`` records) — and a full snapshot rotates the
  segment and GCs everything it covers. Delta payloads per app: TX
  redo-log records past a per-replica high-water mark (the store is
  derivable), a KVS dirty-row diff against a shadow copy, or the LM
  paged pool's dirty *pages* (and the host cold tier's slabs). The
  full-vs-delta decision is re-made per flush from measured dirty bytes;
  with a ``placement.MemoryBudget`` attached the dirty threshold scales
  with the shared ledger's occupancy.
* :func:`recover` — restart path: garbage-collect torn ``.tmp`` leftovers,
  **truncate torn segment tails at the last valid CRC frame**, restore the
  latest committed snapshot onto the like-state's device, then replay
  chained WAL records in step order. The JAX package replays TX records
  through the plain path; here they go through ``kernel_backend``
  (default ``auto``: on the card one ``commit`` launch per record).
  Passing the restarted process's ``HostColdTier`` as ``cold`` restores
  the LM cold slabs and allocator bookkeeping too.

Release semantics (group commit, driven by ``fault.soak``): a response is
delivered to the client only once a *committed* flush covers its
production (``resp.tail``). A flush commits when its bytes are fsynced —
on snapshot rename for full flushes, on the group fsync for streamed
records. The JAX soak reads ``last_committed()`` right after a flush hands
its work to the worker, so what it releases depends on the worker's
timing. The port's drivers read :meth:`DurabilityManager.settled`: the
last flush committed when the latest ``flush`` joined the previous
worker, a function of the flush sequence alone.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.checkpoint import wal
from repro_torch.core import kvstore
from repro_torch.core import transaction as tx
from repro_torch.fault import chain as fchain

# delta-record kind tags (stored in the WAL metadata)
KIND_TX = 0
KIND_KVS = 1
KIND_LM = 2

_TX_BIG = (".app/.log", ".app/.store")
_LM_BIG_SUFFIXES = (".decode/.k_pages", ".decode/.v_pages")
_COLD_BIG = ("cold/k", "cold/v")


class DurabilityConfig(NamedTuple):
    """Flush policy for one engine.

    ``every``: flush cadence in engine steps (the driver's contract).
    ``snapshot_every``: at most this many steps between *full* snapshots in
    the delta modes (bounds replay length). ``mode``: ``"full"`` = every
    flush is a full snapshot; ``"delta"`` = WAL-delta between snapshots;
    ``"adaptive"`` = delta, escaping to full when measured dirty bytes
    exceed ``dirty_threshold`` × full-state bytes. ``wal``: ``"segment"``
    streams deltas into group-fsynced ``seg_<N>.log`` files (one fsync per
    ``group_records``); ``"npz"`` is the one-file-one-fsync ``wal_<N>.npz``
    path. ``skip_busy``: drop a flush instead of stalling the driver behind
    a slow previous one (counted in ``flushes_skipped``)."""

    directory: str
    every: int = 1
    snapshot_every: int = 32
    mode: str = "adaptive"
    dirty_threshold: float = 0.5
    wal: str = "segment"
    group_records: int = 4
    segment_bytes: int = 1 << 20
    skip_busy: bool = False


@dataclasses.dataclass
class FlushRecord:
    """One flush, as the release-gating driver sees it.

    Created by ``flush`` with the at-capture ring coverage; ``kind`` /
    ``bytes`` are resolved by the worker (read them after ``wait()``), and
    ``committed`` flips once the record's bytes are fsynced — snapshot
    rename for fulls, the group fsync for streamed deltas. ``copy_bytes``
    and ``copy_us`` are the synchronous device-to-host copy of the flush."""

    step: int
    kind: str  # "pending" -> "full" | "delta" | "skipped"
    bytes: int
    req_tail: np.ndarray  # (Q,) landing coverage at capture
    resp_tail: np.ndarray  # (Q,) production coverage at capture
    resp_head: np.ndarray  # (Q,) drain position at capture
    committed: bool = False
    wait_us: float = 0.0  # driver stall joining the previous flush
    copy_bytes: int = 0
    copy_us: float = 0.0


def _app_kind(app) -> str:
    if isinstance(app, tx.ReplicaState):
        return "tx"
    if isinstance(app, kvstore.KVState):
        return "kvs"
    return "opaque"


def _tree_kind(host) -> str:
    """Durability classification of a host engine state."""
    app = getattr(host, "app", None)
    if app is not None:
        return _app_kind(app)
    decode = getattr(host, "decode", None)
    if decode is not None and hasattr(decode, "k_pages"):
        return "lm"  # paged LM pool: page-granular dirty diff
    return "opaque"


def _lm_page_keys(flat) -> list[str]:
    """Flat keys diffed along the page axis (axis 1) for LM deltas."""
    return [key for key in flat
            if key.endswith(_LM_BIG_SUFFIXES) or key in _COLD_BIG]


def derive_tx_cfg(app: tx.ReplicaState) -> tx.TxConfig:
    """Recover the TxConfig geometry from a replica/chain state's shapes
    (everything replay needs is encoded in them)."""
    chain = app.log_tail.dim() > 0
    num_keys = int(app.store.shape[-2]) - 1
    val_words = int(app.store.shape[-1])
    log_capacity = int(app.log.shape[-2]) - 1
    tw = int(app.log.shape[-1])
    max_ops = (tw - 1) // (1 + val_words)
    chain_len = int(app.log_tail.shape[0]) if chain else 1
    return tx.TxConfig(
        num_keys=num_keys, val_words=val_words, max_ops=max_ops,
        chain_len=chain_len, log_capacity=log_capacity,
    )


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            total += os.path.getsize(os.path.join(root, f))
    return total


def _counter(t: torch.Tensor) -> np.ndarray:
    return t.numpy().copy()


class DurabilityManager:
    """Flush engine state to the host NVM tier; one outstanding flush.

    ``flush(state)`` copies the state to the host synchronously (so the
    device state may be written right after) and submits everything else —
    dirty diff, full-vs-delta decision, snapshot write or streamed WAL
    append — to the checkpointer's single worker thread. ``records`` lists
    every flush (with its payload bytes once the worker resolves them);
    ``committed`` lists flushes whose bytes are fsynced. ``wait()`` drains
    the worker *and* forces the trailing group fsync, so after it every
    submitted flush is durable.

    ``budget`` (a ``placement.MemoryBudget``) folds shared-ledger pressure
    into the adaptive split; ``cold`` (a ``HostColdTier``) pulls the LM
    host slabs into every flush payload (wrapped as
    ``{"engine": state, "cold": arrays}``)."""

    def __init__(self, cfg: DurabilityConfig, *, budget=None, cold=None):
        self.cfg = cfg
        self.budget = budget
        self.cold = cold
        self._ckpt = ckpt.AsyncCheckpointer(cfg.directory)
        self._writer = (
            wal.SegmentWriter(cfg.directory, segment_bytes=cfg.segment_bytes)
            if cfg.wal == "segment" else None
        )
        self._base_step: Optional[int] = None
        self._prev_covered: Optional[int] = None
        self._hw: Optional[np.ndarray] = None  # TX per-replica high-water
        self._shadow: dict[str, torch.Tensor] = {}  # big arrays @ last flush
        self.records: list[FlushRecord] = []
        # appended by the worker thread once durable; reading a list
        # snapshot from the driver thread is safe under the GIL
        self._committed: list[FlushRecord] = []
        self._pending: list[FlushRecord] = []  # appended, not yet fsynced
        self._settled: Optional[FlushRecord] = None
        # backpressure / amortization stats
        self.flush_wait_us = 0.0
        self.flushes_skipped = 0
        self.disk_bytes = 0
        self.gc_removed = 0
        self.copy_us = 0.0
        self.copy_bytes = 0
        self._npz_fsyncs = 0
        self._npz_records = 0

    # -- flush ------------------------------------------------------------

    def flush(self, state) -> FlushRecord:
        """Flush ``state`` (an engine state); returns the submitted record.
        The flush is durable once ``committed`` flips (after the snapshot
        rename / the covering group fsync)."""
        t0 = time.perf_counter()
        host = ckpt.host_copy(state)
        copy_us = (time.perf_counter() - t0) * 1e6
        step = int(host.steps)
        tree: Any = host
        if self.cold is not None:
            tree = {"engine": host, "cold": self.cold.state_arrays()}
        rec = FlushRecord(
            step, "pending", 0, _counter(host.req.tail),
            _counter(host.resp.tail), _counter(host.resp.head),
            copy_bytes=sum(ckpt.nbytes(v)
                           for v in ckpt._flatten(host).values()),
            copy_us=copy_us,
        )
        self.copy_us += copy_us
        self.copy_bytes += rec.copy_bytes
        if self.cfg.skip_busy and self._ckpt.busy():
            rec.kind = "skipped"
            self.flushes_skipped += 1
            self.records.append(rec)
            return rec
        t0 = time.perf_counter()
        self._ckpt.wait()  # one outstanding flush: join the previous one
        self._settled = self.last_committed()
        self._ckpt.submit(lambda: self._worker_flush(rec, host, tree, step))
        rec.wait_us = (time.perf_counter() - t0) * 1e6
        self.flush_wait_us += rec.wait_us
        self.records.append(rec)
        return rec

    def _worker_flush(self, rec: FlushRecord, host, tree, step: int) -> None:
        """Worker-side half: diff, decide, write. Runs on the single
        checkpointer thread (submit joins the previous one), so the chain
        bookkeeping below is only ever touched sequentially."""
        flat = ckpt._flatten(tree)
        full_bytes = sum(ckpt.nbytes(v) for v in flat.values())
        kind = _tree_kind(host)
        delta = None
        if kind != "opaque" and self.cfg.mode in ("delta", "adaptive"):
            delta = self._build_delta(host, flat, kind, step)
        directory = self.cfg.directory
        if self._decide(step, delta, full_bytes):
            rec.kind, rec.bytes = "full", full_bytes
            # commit streamed records *before* the snapshot supersedes them
            self._sync_pending()
            ckpt.save(directory, step, tree)
            self.disk_bytes += _dir_bytes(
                os.path.join(directory, f"step_{step}"))
            self._base_step = step
            if self._writer is not None:
                self._writer.rotate()
            removed = wal.gc_covered(directory, step)
            self.gc_removed += len(removed)
            rec.committed = True
            self._committed.append(rec)
        else:
            arrays, meta, nbytes = delta
            rec.kind, rec.bytes = "delta", nbytes
            if self._writer is None:  # one-file-one-fsync npz path
                path = ckpt.save_delta(directory, step, arrays, meta)
                self._npz_records += 1
                self._npz_fsyncs += 1
                self.disk_bytes += os.path.getsize(path)
                rec.committed = True
                self._committed.append(rec)
            else:
                self.disk_bytes += self._writer.append(step, arrays, meta)
                self._pending.append(rec)
                if len(self._pending) >= self.cfg.group_records:
                    self._sync_pending()
        # advance the dirty baselines to this flush point
        if kind == "tx":
            self._hw = np.atleast_1d(host.app.log_tail.numpy()).copy()
        elif kind == "kvs":
            for name in kvstore.DURABLE_ROW_ARRAYS:
                self._shadow[name] = flat[f".app/.{name}"]
        elif kind == "lm":
            for key in _lm_page_keys(flat):
                self._shadow[key] = flat[key]
        if self.budget is not None:
            self.budget.note_write(rec.bytes)
        self._prev_covered = step

    def _sync_pending(self) -> None:
        """Group commit: one fsync covers every pending streamed record.
        (``writer.pending`` counts only unsynced appends, so records that
        an auto-rotation already fsynced commit here without a new one.)"""
        if self._writer is not None:
            self._writer.sync()
        for r in self._pending:
            r.committed = True
            self._committed.append(r)
        self._pending.clear()

    def _decide(self, step: int, delta, full_bytes: int) -> bool:
        """The adaptive DRAM-vs-NVM split, per flush from measured bytes."""
        if self._base_step is None or self.cfg.mode == "full" or delta is None:
            return True
        if step - self._base_step >= self.cfg.snapshot_every:
            return True  # bound the replay chain
        _arrays, meta, nbytes = delta
        if meta.get("lapped", 0):
            return True  # TX ring lapped the high-water mark: window gone
        threshold = self.cfg.dirty_threshold
        if self.budget is not None:
            # unified server-memory view: the fuller the shared pool, the
            # more the flush policy prefers the smaller delta write
            threshold = self.budget.durability_threshold(threshold)
        if self.cfg.mode == "adaptive" and nbytes > threshold * full_bytes:
            return True  # mostly dirty: the delta stopped paying for itself
        return False

    def _build_delta(self, host, flat, kind: str, step: int):
        """Materialize the WAL-delta payload (and its measured bytes)."""
        arrays: dict[str, Any] = {}
        meta: dict[str, int] = {
            "step": step,
            "base_step": -1 if self._base_step is None else self._base_step,
            "prev_covered": (-1 if self._prev_covered is None
                             else self._prev_covered),
            "kind": {"tx": KIND_TX, "kvs": KIND_KVS, "lm": KIND_LM}[kind],
            "lapped": 0,
        }
        big: set[str] = set()
        if kind == "tx":
            big = set(_TX_BIG)
            tails = np.atleast_1d(host.app.log_tail.numpy())
            hw = self._hw if self._hw is not None else np.zeros_like(tails)
            lc = host.app.log_capacity
            log = host.app.log
            if log.dim() == 2:
                log = log[None]
            for r in range(tails.shape[0]):
                lo, hi = int(hw[r]), int(tails[r])
                if hi - lo > lc:
                    meta["lapped"] = 1  # the decision forces a full snapshot
                if 0 < hi - lo <= lc:
                    rows = log[r, torch.arange(lo, hi) % lc]
                else:
                    rows = log.new_zeros((0, log.shape[-1]))
                arrays[f"rows{r}"] = rows
                meta[f"hw{r}"] = lo
                meta[f"tail{r}"] = hi
        elif kind == "kvs":  # materialized dirty-row diff against the shadow
            for name in kvstore.DURABLE_ROW_ARRAYS:
                key = f".app/.{name}"
                big.add(key)
                a = flat[key]
                prev = self._shadow.get(name)
                if prev is None or prev.shape != a.shape:
                    idx = torch.arange(a.shape[0], dtype=torch.int64)
                else:
                    n = a.shape[0]
                    dirty = (a.reshape(n, -1) != prev.reshape(n, -1)).any(1)
                    idx = torch.nonzero(dirty)[:, 0]
                arrays[f"di:{name}"] = idx
                arrays[f"dr:{name}"] = a[idx]
        else:  # lm: dirty *pages* (axis 1) of the paged pool + cold slabs
            for key in _lm_page_keys(flat):
                big.add(key)
                a = flat[key]
                prev = self._shadow.get(key)
                if prev is None or prev.shape != a.shape:
                    idx = torch.arange(a.shape[1], dtype=torch.int64)
                else:
                    dirty = (a != prev).transpose(0, 1).reshape(
                        a.shape[1], -1).any(1)
                    idx = torch.nonzero(dirty)[:, 0]
                arrays[f"dp:{key}"] = idx
                arrays[f"pr:{key}"] = a[:, idx]
        # everything that isn't a diffed big array travels verbatim — ring
        # bytes, counters, cursors are small next to the store/log/pool
        for key, v in flat.items():
            if key not in big:
                arrays[f"c:{key}"] = v
        nbytes = sum(ckpt.nbytes(v) for v in arrays.values())
        return arrays, meta, nbytes

    # -- observation ------------------------------------------------------

    def committed(self) -> list[FlushRecord]:
        return list(self._committed)

    def last_committed(self) -> Optional[FlushRecord]:
        c = self._committed
        return c[-1] if c else None

    def settled(self) -> Optional[FlushRecord]:
        """The last flush that was committed when the latest :meth:`flush`
        joined the previous worker (after :meth:`wait`: the last committed
        one). Unlike :meth:`last_committed` right after a flush, it never
        depends on how far the worker has got, so a driver that releases
        on it does the same at every run."""
        return self._settled

    def flush_bytes(self) -> int:
        return sum(r.bytes for r in self.records)

    @property
    def fsyncs(self) -> int:
        w = self._writer
        return (w.fsyncs if w is not None else 0) + self._npz_fsyncs

    @property
    def wal_records(self) -> int:
        w = self._writer
        return (w.records if w is not None else 0) + self._npz_records

    def stats(self) -> dict[str, Any]:
        """Backpressure + amortization counters for the stats surfaces
        (soak reports, ``launch/serve.py``'s final print), and the
        device-to-host copies of the flushes."""
        return {
            "flush_wait_us": round(self.flush_wait_us, 3),
            "flushes_skipped": self.flushes_skipped,
            "fsyncs": self.fsyncs,
            "wal_records": self.wal_records,
            "disk_bytes": self.disk_bytes,
            "gc_removed": self.gc_removed,
            "host_copy_us": round(self.copy_us, 3),
            "host_copy_bytes": self.copy_bytes,
        }

    def wait(self):
        """Drain the worker and force the trailing group fsync: after this
        every submitted flush is committed (the soak's crash barrier)."""
        self._ckpt.wait()
        self._sync_pending()
        self._settled = self.last_committed()


# ---------------------------------------------------------------------------
# Restart path
# ---------------------------------------------------------------------------

def recover(directory: str, like, *, tx_cfg: Optional[tx.TxConfig] = None,
            kernel_backend: Optional[str] = "auto", cold=None,
            stats: Optional[dict] = None):
    """Restart-recover an engine from its durability directory.

    Cleans torn ``.tmp`` leftovers and truncates torn segment tails at the
    last valid CRC frame, restores the latest committed full snapshot into
    the structure of ``like`` (a live-or-fresh engine state of identical
    geometry, on the device to recover onto), then applies committed WAL
    records in step order — TX deltas by per-record replay
    (:func:`transaction.replay_records` per ``kernel_backend``; the store
    re-derives from the log), KVS deltas by dirty-row scatter, LM deltas
    by dirty-page scatter, each followed by the verbatim control
    overwrite. With ``cold`` (the restarted process's ``HostColdTier``)
    the recovered cold slabs + allocator bookkeeping are installed on it.
    ``stats``, if given, is filled with ``snapshot_step``,
    ``wal_records`` (deltas applied), ``tx_records`` (redo records
    replayed) and ``truncated`` (torn segments cut back).

    Returns ``(state, covered_step)`` — ``state.steps == covered_step``,
    bit-for-bit the state at the last committed flush. Raises
    ``FileNotFoundError`` when no committed snapshot exists."""
    base = ckpt.latest_step(directory, clean_stale_files=True)
    if base is None:
        raise FileNotFoundError(
            f"recover: no committed snapshot under {directory!r}"
        )
    like_tree: Any = like
    if cold is not None:
        like_tree = {"engine": like, "cold": cold.zero_arrays()}
    tree, _ = ckpt.restore(directory, base, like_tree)
    covered = base
    merged = [(s, None) for s in ckpt.list_deltas(directory)]
    seg_records, truncated = wal.read_segments(directory, truncate_torn=True)
    merged += [(s, (arrays, meta)) for s, arrays, meta in seg_records]
    merged.sort(key=lambda t: t[0])
    applied = replayed = 0
    for s, payload in merged:
        if s <= base:
            continue  # superseded by a later full snapshot
        arrays, meta = (payload if payload is not None
                        else ckpt.load_delta(directory, s))
        if meta["base_step"] != base or meta["prev_covered"] != covered:
            raise ValueError(
                f"recover: WAL chain break at step {s} (base "
                f"{meta['base_step']}/{base}, prev {meta['prev_covered']}"
                f"/{covered})"
            )
        if meta["kind"] == KIND_TX:
            tree = _apply_tx_delta(tree, arrays, meta, tx_cfg, kernel_backend)
            replayed += sum(len(v) for k, v in arrays.items()
                            if k.startswith("rows"))
        elif meta["kind"] == KIND_KVS:
            tree = _apply_kvs_delta(tree, arrays)
        else:
            tree = _apply_lm_delta(tree, arrays)
        tree = _overwrite_control(tree, arrays)
        covered = s
        applied += 1
    if cold is not None:
        state = tree["engine"]
        cold.restore_arrays(tree["cold"])
    else:
        state = tree
    if int(state.steps) != covered:
        raise ValueError(f"recover: state at step {int(state.steps)}, the "
                         f"WAL covers step {covered}")
    if stats is not None:
        stats.update(snapshot_step=base, wal_records=applied,
                     tx_records=replayed, truncated=truncated)
    return state, covered


def _apply_tx_delta(state, arrays, meta, tx_cfg, kernel_backend):
    app = state.app
    cfg = tx_cfg if tx_cfg is not None else derive_tx_cfg(app)
    single = app.log_tail.dim() == 0
    nrep = 1 if single else int(app.log_tail.shape[0])
    dev = app.log.device
    for r in range(nrep):
        rep = app if single else fchain.replica_view(app, r)
        hw, tail = meta[f"hw{r}"], meta[f"tail{r}"]
        have = int(rep.log_tail)
        if have != hw:
            raise ValueError(
                f"recover: replica {r} log_tail {have} != WAL high-water {hw}"
            )
        records = arrays[f"rows{r}"]
        if len(records):
            # replay with the replica forced live — a dead replica's commit
            # freezes, but the records prove it executed them before dying
            # (dead replicas don't log); the delta's control section
            # restores the at-flush live mask right after
            rep = rep._replace(live=torch.ones((), dtype=torch.bool,
                                               device=dev))
            rep = tx.replay_records(rep, records.to(dev), cfg,
                                    kernel_backend=kernel_backend)
        got = int(rep.log_tail)
        if got != tail:
            raise ValueError(
                f"recover: replica {r} replay ended at {got}, expected {tail}"
            )
        app = rep if single else fchain.write_replica(app, r, rep)
    return state._replace(app=app)


def _apply_kvs_delta(state, arrays):
    """Scatter dirty rows back, in place on the freshly restored state."""
    app = state.app
    for name in kvstore.DURABLE_ROW_ARRAYS:
        idx = arrays[f"di:{name}"]
        if len(idx):
            t = getattr(app, name)
            t[idx.to(t.device)] = arrays[f"dr:{name}"].to(t.device)
    return state


def _apply_lm_delta(tree, arrays):
    """Scatter dirty pages (axis 1) back into the paged pool / cold slabs,
    in place on the freshly restored tree."""
    flat = ckpt._flatten(tree)
    for name, idx in arrays.items():
        if not name.startswith("dp:") or not len(idx):
            continue
        key = name[len("dp:"):]
        base = flat[key]
        base[:, idx.to(base.device)] = arrays["pr:" + key].to(
            device=base.device, dtype=base.dtype)
    return tree


def _overwrite_control(state, arrays):
    """Apply the delta's verbatim section: every non-diffed leaf (ring
    bytes, counters, cursors, liveness) at its at-flush value, on the
    restored leaf's device. Runs last so replayed counters are *checked*
    against, then replaced by, the flushed truth."""
    flat = ckpt._flatten(state)
    for key, v in arrays.items():
        if key.startswith("c:"):
            old = flat[key[2:]]
            flat[key[2:]] = v.to(device=old.device, dtype=old.dtype)
    return ckpt.rebuild(state, flat)
