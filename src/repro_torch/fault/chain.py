"""Chain-replica failover: host-side kill / revive / log-replay resync.

The port of the JAX package's ``fault/chain.py``. The device half of chain
shortening lives in ``core.transaction``: each
:class:`~repro_torch.core.transaction.ReplicaState` carries a ``live``
flag, and the commit walks skip dead replicas with fixed shapes — a dead
replica's log/store scatters retarget its sentinel rows and its
``log_tail``/``committed`` counters freeze. This module is the host half:

* :func:`resync_replica` — replay the nearest live neighbour's redo log
  into a revived replica, one record at a time, exactly the write-ahead
  order the survivors executed. Because proceeding transactions within a
  batch have disjoint write sets, per-record replay reproduces the
  survivors' store and log ring **bit-for-bit**. When the gap exceeds the
  log ring's capacity (the ring lapped the dead replica's frozen tail) the
  replay window is gone and the replica is restored by a full state copy.
  The JAX package replays through the plain path; here the replay goes
  through ``kernel_backend`` (default ``auto``), so on the card every
  replayed record is one launch of the ``commit`` kernel.
* :class:`ChainMonitor` — liveness bookkeeping built on
  ``watchdog.Heartbeat``: replicas beat a per-replica heartbeat file,
  :meth:`ChainMonitor.sweep` kills stale replicas and revives (resyncs)
  fresh ones; :meth:`ChainMonitor.apply_events` applies a
  ``FaultInjector`` kill/revive schedule. Killing the last live replica
  is refused — chain replication degrades, it does not lose the data.

Mutation: a revived replica's store and log are written IN PLACE in the
chain's tensors (the commits write in place, and a replica is a view of
its chain slot); the counters and the ``live`` mask come back as new
tensors in the returned chain.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.core import transaction as tx
from repro_torch.fault.watchdog import Heartbeat

_IN_PLACE = ("store", "log")


def replica_view(chain: tx.ReplicaState, r: int) -> tx.ReplicaState:
    """Replica ``r`` of a chain (leading replica axis), as views."""
    return tx.ReplicaState(*(x[r] for x in chain))


def write_replica(chain: tx.ReplicaState, r: int,
                  rep: tx.ReplicaState) -> tx.ReplicaState:
    """Write a single-replica state into chain slot ``r``: the store and
    log in place (a no-op where ``rep`` already is that slot's view), the
    counters and ``live`` as new tensors."""
    out = {}
    for f in tx.ReplicaState._fields:
        c, x = getattr(chain, f), getattr(rep, f)
        if f in _IN_PLACE:
            if c[r].data_ptr() != x.data_ptr():
                c[r].copy_(x)
            out[f] = c
        else:
            c = c.clone()
            c[r] = x
            out[f] = c
    return tx.ReplicaState(**out)


def _live_mask(chain: tx.ReplicaState):
    return chain.live.cpu().numpy()


def resync_replica(chain: tx.ReplicaState, cfg: tx.TxConfig, r: int,
                   source: Optional[int] = None, *,
                   kernel_backend: Optional[str] = "auto") -> tx.ReplicaState:
    """Re-sync replica ``r`` from a live neighbour's redo log and mark it
    live. Default source = nearest live predecessor (chain order), else
    nearest live successor.

    The revived replica's ``log_tail`` froze at death, so the gap is
    exactly ``source.log_tail - r.log_tail`` records; each is replayed
    through the normal plan/commit path (``proceed`` forced True — the
    log only ever holds transactions that proceeded) so the store scatter,
    log ring slot, and counter bumps are the very ones the survivors
    executed. Gap > log_capacity means the ring lapped the frozen tail:
    full state copy."""
    live = _live_mask(chain)
    nrep = live.shape[0]
    if source is None:
        cands = [i for i in range(r - 1, -1, -1) if live[i]]
        cands += [i for i in range(r + 1, nrep) if live[i]]
        if not cands:
            raise ValueError("resync_replica: no live source replica")
        source = cands[0]
    src = replica_view(chain, source)
    alive = torch.ones((), dtype=torch.bool, device=chain.live.device)
    dst = replica_view(chain, r)._replace(live=alive)
    lo, hi = int(dst.log_tail), int(src.log_tail)
    if hi < lo:
        raise ValueError(
            f"resync_replica: replica {r} is ahead of source {source} "
            f"({lo} > {hi}) — dead replicas freeze, they never advance"
        )
    lc = cfg.log_capacity
    if hi - lo > lc:
        # the replay window fell off the ring: restore by full copy
        dst = src._replace(live=alive)
    else:
        slots = torch.arange(lo, hi, device=src.log.device) % lc
        dst = tx.replay_records(dst, src.log[slots], cfg,
                                kernel_backend=kernel_backend)
    return write_replica(chain, r, dst)


class ChainMonitor:
    """Host-side liveness authority for one local chain.

    Composes ``watchdog.Heartbeat`` (file-mtime liveness) with the
    mask-based chain shortening in ``core.transaction``: replicas call
    :meth:`beat`; :meth:`sweep` compares heartbeat ages against
    ``timeout`` (an explicit ``now`` makes it deterministic under test)
    and flips the chain's ``live`` mask — killing stale replicas,
    reviving-and-resyncing fresh ones. ``events`` records every
    transition as ``("kill" | "revive", replica)``.

    ``directory=None`` runs schedule-only (no heartbeat files): only
    :meth:`apply_events` / :meth:`kill` / :meth:`revive` drive
    transitions — the mode the deterministic soak uses. ``replayed``
    counts the redo records the revive resyncs replayed (a full copy
    replays none).
    """

    def __init__(self, cfg: tx.TxConfig, directory: Optional[str] = None,
                 timeout: float = 5.0):
        self.cfg = cfg
        self.directory = directory
        self.timeout = timeout
        self.events: list = []
        self.replayed = 0
        self.hbs = {}
        if directory is not None:
            self.hbs = {
                r: Heartbeat(directory, r) for r in range(cfg.chain_len)
            }

    def beat(self, r: int):
        self.hbs[r].beat()

    def kill(self, chain: tx.ReplicaState, r: int) -> tx.ReplicaState:
        live = _live_mask(chain)
        if live[r] and int(live.sum()) <= 1:
            raise ValueError(
                "ChainMonitor.kill: refusing to kill the last live replica"
            )
        self.events.append(("kill", int(r)))
        mask = chain.live.clone()
        mask[r] = False
        return chain._replace(live=mask)

    def revive(self, chain: tx.ReplicaState, r: int) -> tx.ReplicaState:
        before = int(chain.log_tail[r])
        chain = resync_replica(chain, self.cfg, r)
        gap = int(chain.log_tail[r]) - before
        self.replayed += gap if gap <= self.cfg.log_capacity else 0
        self.events.append(("revive", int(r)))
        return chain

    def apply_events(self, chain: tx.ReplicaState, events) -> tx.ReplicaState:
        """Apply a ``FaultInjector.tick`` event list."""
        for kind, r in events:
            if kind == "kill":
                chain = self.kill(chain, r)
            elif kind == "revive":
                chain = self.revive(chain, r)
            else:
                raise ValueError(f"unknown chain event {kind!r}")
        return chain

    def sweep(self, chain: tx.ReplicaState,
              now: Optional[float] = None) -> tx.ReplicaState:
        """Heartbeat sweep: kill replicas whose heartbeat went stale,
        revive ones whose heartbeat came back. A replica that never beat
        has no file and is left alone (it was never admitted)."""
        if self.directory is None:
            raise ValueError("ChainMonitor.sweep needs a heartbeat directory")
        stale = set(Heartbeat.dead_hosts(self.directory, self.timeout,
                                         now=now))
        live = _live_mask(chain)
        for r in range(self.cfg.chain_len):
            has_file = os.path.exists(self.hbs[r].path)
            if live[r] and r in stale and int(live.sum()) > 1:
                chain = self.kill(chain, r)
                live = _live_mask(chain)
            elif not live[r] and has_file and r not in stale:
                chain = self.revive(chain, r)
                live = _live_mask(chain)
        return chain
