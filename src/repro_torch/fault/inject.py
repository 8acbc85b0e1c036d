"""Deterministic seeded fault injection at the engine's host step boundary.

The port of the JAX package's ``fault/inject.py``. The ORCA datapath
(rings -> cpoll -> scheduler -> APU) is exercised by a driver loop that
injects requests and drains responses between engine steps. :class:`FaultInjector` wraps exactly that boundary: every request
handed to :meth:`FaultInjector.inject` rolls one fault class from a seeded
``numpy`` RNG stream, so a given ``(seed, workload)`` pair replays the
same fault schedule bit-for-bit — the same draws as the JAX package's
injector for the same seed, since both use ``np.random.default_rng``
(never a torch generator) — so the soak harness (``fault.soak``) and
the degraded-chain benchmark arm lean on this determinism to diff a
faulted run against a never-faulted control run.

Fault classes (mutually exclusive per entry, probabilities from
:class:`FaultConfig`):

* **drop** — the entry vanishes on the wire. The client believes the send
  succeeded; only its own timeout + resubmission recovers the request.
* **duplicate** — the entry is delivered twice back-to-back (same queue,
  two ring slots). Stresses idempotency: the TX app's first-claimant
  concurrency control defers the second copy when both land in one batch,
  and a re-commit of identical values is state-idempotent.
* **corrupt** — payload words are overwritten with garbage before
  delivery. Stresses the apps' in-step validation: a corrupted opcode /
  op-count / offset must come back ``status.MALFORMED``, never scatter.
* **delay** — delivery is postponed ``delay_min..delay_max`` engine steps
  (released by :meth:`FaultInjector.tick`), reordering arrivals across
  queues while preserving per-queue FIFO of *landed* entries.
* **suppress** — the entry lands in the ring but its doorbell is withheld
  for ``suppress_steps`` steps: the cpoll pointer buffer lags the ring
  tail, stressing notification coalescing (a late doorbell must surface
  every entry it covers exactly once).

Replica kill/revive is schedule-driven (not random): ``kill_schedule`` /
``revive_schedule`` are ``(step, replica)`` pairs surfaced as events from
:meth:`FaultInjector.tick`; the driver applies them through
``fault.chain.ChainMonitor`` (see [[fault-chain]] / README "Failure model
& degraded modes").

Client-side recovery helpers: :class:`NackError` marks a negative
response status word (``core/status.py``) as a *transient* failure —
its message embeds ``DEADLINE_EXCEEDED`` so ``watchdog.is_transient``
classifies it — and :func:`request_with_retries` is
``watchdog.with_retries`` tuned for the request path (resubmit with
exponential backoff).
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import cpoll as cp
from repro_torch.core import ringbuf as rb
from repro_torch.fault.watchdog import with_retries

I32 = torch.int32

#: counter keys asserted >= 1 by the soak's "every fault class fired" check
FAULT_CLASSES = ("dropped", "duplicated", "corrupted", "delayed", "suppressed")


class FaultConfig(NamedTuple):
    seed: int = 0
    p_drop: float = 0.0
    p_dup: float = 0.0
    p_corrupt: float = 0.0
    p_delay: float = 0.0
    p_suppress: float = 0.0
    delay_min: int = 1  # steps a delayed entry is held (inclusive range)
    delay_max: int = 4
    suppress_steps: int = 2  # steps a suppressed doorbell is withheld
    corrupt_words: int = 2  # payload words overwritten per corruption
    # schedule-driven chain faults: (step, replica) pairs, surfaced as
    # ("kill"/"revive", replica) events from tick()
    kill_schedule: Tuple[Tuple[int, int], ...] = ()
    revive_schedule: Tuple[Tuple[int, int], ...] = ()


class NackError(RuntimeError):
    """A request was NACKed (negative status word) or could not be
    enqueued (ring credit exhausted). The message embeds
    ``DEADLINE_EXCEEDED`` so ``watchdog.is_transient`` treats it as
    retryable — resubmitting the pristine payload is the correct
    recovery for wire corruption, shedding, and credit stalls alike."""

    def __init__(self, status_word: int, detail: str = ""):
        self.status = int(status_word)
        super().__init__(
            f"request NACKed (status={int(status_word)}; "
            f"DEADLINE_EXCEEDED-class transient). {detail}"
        )


def request_with_retries(fn, *args, retries: int = 4, backoff: float = 0.005,
                         on_retry=None, **kwargs):
    """``watchdog.with_retries`` tuned for the request path: resubmit a
    NACKed / credit-rejected request with exponential backoff."""
    return with_retries(
        fn, *args, retries=retries, backoff=backoff, on_retry=on_retry,
        **kwargs
    )


class FaultInjector:
    """Seeded fault layer between a host driver and an engine state.

    Works against any engine state carrying ``req`` (ringbuf.RingState)
    and ``cpoll`` (cpoll.CpollState) fields — both ``EngineState`` and
    ``LMEngineState`` qualify. The injector is pure host-side: it only
    composes the same ``ringbuf.enqueue`` / ``cpoll.doorbell`` calls the
    real producer path uses, so the engine step never sees it. Ring
    counters stay the engines' int32 tensors, with their wrap.

    ``landed`` records every entry that actually reached a ring, in ring
    order per queue — the ground truth the conservation checks match
    responses against. ``counters`` tallies offered / landed / rejected
    plus one counter per fault class.
    """

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.now = 0  # engine steps completed; advance via tick()
        self.counters = collections.Counter(
            offered=0, landed=0, rejected=0, doorbells_released=0,
            **{k: 0 for k in FAULT_CLASSES},
        )
        # (step_landed, queue, payload np.ndarray, tag) in landing order
        self.landed: list = []
        self._delayed: list = []  # (release_step, queue, payload, tag)
        # (release_step, queue, landed_index) — the per-queue landing ordinal
        # of the suppressed entry, so a crash reconciliation can tell which
        # withheld doorbells cover entries that survived in the restored ring
        self._doorbells: list = []
        self._landed_q = collections.Counter()  # per-queue landing ordinals

    # -- delivery ----------------------------------------------------------

    def _classify(self) -> str:
        u = float(self.rng.random())
        acc = 0.0
        for name, p in (
            ("drop", self.cfg.p_drop), ("dup", self.cfg.p_dup),
            ("corrupt", self.cfg.p_corrupt), ("delay", self.cfg.p_delay),
            ("suppress", self.cfg.p_suppress),
        ):
            acc += p
            if u < acc:
                return name
        return "ok"

    def _land(self, state, queue_id: int, payload, tag,
              ring_doorbell: bool = True):
        """Deliver one entry to the ring; doorbell only when asked.
        Returns (state, accepted)."""
        dev = state.req.entries.device
        qi = torch.tensor([int(queue_id)], dtype=I32, device=dev)
        pay = torch.as_tensor(np.asarray(payload).reshape(1, -1)).to(
            dtype=I32, device=dev)
        req, ok = rb.enqueue(state.req, qi, pay)
        if not bool(ok[0]):
            self.counters["rejected"] += 1
            return state, False
        if ring_doorbell:
            cpo = cp.doorbell(state.cpoll, qi, torch.ones((1,), dtype=I32,
                                                          device=dev))
            state = state._replace(req=req, cpoll=cpo)
        else:
            state = state._replace(req=req)
        self.landed.append(
            (self.now, int(queue_id), np.asarray(payload).copy(), tag)
        )
        self.counters["landed"] += 1
        self._landed_q[int(queue_id)] += 1
        return state, True

    def inject(self, state, queue_id: int, payload, tag=None):
        """Offer one request to the wire. Returns ``(state, accepted)`` —
        ``accepted`` is the *client's* view (a dropped or delayed entry
        still reads as a successful send; only a ring-credit rejection
        reads False, and the caller should back off and resubmit)."""
        self.counters["offered"] += 1
        kind = self._classify()
        if kind == "drop":
            self.counters["dropped"] += 1
            return state, True  # the wire ate it; client timeout recovers
        if kind == "delay":
            d = int(self.rng.integers(self.cfg.delay_min,
                                      self.cfg.delay_max + 1))
            self._delayed.append(
                (self.now + d, int(queue_id), np.asarray(payload).copy(), tag)
            )
            self.counters["delayed"] += 1
            return state, True
        if kind == "corrupt":
            payload = np.asarray(payload).copy()
            nw = min(self.cfg.corrupt_words, payload.shape[-1])
            idx = self.rng.choice(payload.shape[-1], size=nw, replace=False)
            payload[idx] = self.rng.integers(-(2 ** 20), 2 ** 20, size=nw)
            state, acc = self._land(state, queue_id, payload, tag)
            if acc:
                self.counters["corrupted"] += 1
            return state, acc
        if kind == "suppress":
            state, acc = self._land(
                state, queue_id, payload, tag, ring_doorbell=False
            )
            if acc:
                self._doorbells.append(
                    (self.now + self.cfg.suppress_steps, int(queue_id),
                     self._landed_q[int(queue_id)] - 1)
                )
                self.counters["suppressed"] += 1
            return state, acc
        if kind == "dup":
            state, acc = self._land(state, queue_id, payload, tag)
            if acc:
                state, acc2 = self._land(state, queue_id, payload, tag)
                if acc2:
                    self.counters["duplicated"] += 1
            return state, acc
        return self._land(state, queue_id, payload, tag)

    # -- step boundary -----------------------------------------------------

    def tick(self, state):
        """Advance the injector clock one engine step: release due delayed
        entries (re-held a step if the ring has no credit yet) and due
        suppressed doorbells (coalesced per queue), and surface scheduled
        chain events. Returns ``(state, events)`` with events a list of
        ``("kill" | "revive", replica)``."""
        self.now += 1
        held = []
        for (t, q, payload, tag) in self._delayed:
            if t <= self.now:
                state, acc = self._land(state, q, payload, tag)
                if not acc:
                    held.append((t + 1, q, payload, tag))
            else:
                held.append((t, q, payload, tag))
        self._delayed = held
        due = [d for d in self._doorbells if d[0] <= self.now]
        self._doorbells = [d for d in self._doorbells if d[0] > self.now]
        if due:
            cnt = collections.Counter(q for _, q, _ in due)
            qs = sorted(cnt)
            dev = state.cpoll.pointer_buffer.device
            state = state._replace(cpoll=cp.doorbell(
                state.cpoll, torch.tensor(qs, dtype=I32, device=dev),
                torch.tensor([cnt[q] for q in qs], dtype=I32, device=dev),
            ))
            self.counters["doorbells_released"] += len(due)
        events = [("kill", r) for (t, r) in self.cfg.kill_schedule
                  if t == self.now]
        events += [("revive", r) for (t, r) in self.cfg.revive_schedule
                   if t == self.now]
        return state, events

    # -- crash recovery ----------------------------------------------------

    def reconcile_crash(self, state):
        """Re-align the wire with a recovered engine (``fault.recovery``).

        An engine crash rolls its rings back to the last committed flush;
        the wire (this injector = client NIC + link) survives. Three
        repairs, all derived from the recovered monotonic counters:

        * entries that landed *after* the flush were wiped from the
          restored ring — remove them from the landing history (per-queue
          ordinals past the recovered ``req.tail``) and hand them back so
          the driver can NACK + resubmit (they are provably unanswered:
          never covered by a committed flush, hence never released).
        * withheld (suppressed) doorbells for wiped entries are dropped;
          those for surviving entries stay pending.
        * doorbells the dead engine consumed-or-received after the flush
          are lost with it: re-ring the pointer buffer up to
          ``req.tail - still_pending`` per queue, so every surviving entry
          is announced exactly once (coalescing makes the bump safe).

        Returns ``(state, wiped)`` — ``wiped`` as ``(step, q, payload,
        tag)`` landing records. Delayed (not yet landed) entries are
        untouched: they land on the recovered engine like any late packet.
        """
        rec_tail = state.req.tail.cpu().numpy()
        # 1) wipe the landing history past the recovered tails
        kept, wiped = [], []
        seen_q = collections.Counter()
        for entry in self.landed:
            q = entry[1]
            if seen_q[q] < int(rec_tail[q]):
                kept.append(entry)
            else:
                wiped.append(entry)
            seen_q[q] += 1
        self.landed = kept
        self.counters["landed"] -= len(wiped)
        self._landed_q = collections.Counter(
            {q: int(rec_tail[q]) for q in range(rec_tail.shape[0])}
        )
        # 2) drop withheld doorbells that covered wiped entries
        self._doorbells = [
            (t, q, i) for (t, q, i) in self._doorbells if i < int(rec_tail[q])
        ]
        pending = collections.Counter(q for _, q, _ in self._doorbells)
        # 3) re-announce surviving entries the restored pointer buffer and
        # the pending doorbells do not already cover
        pb = state.cpoll.pointer_buffer.cpu().numpy()
        qs, bumps = [], []
        for q in range(rec_tail.shape[0]):
            target = int(rec_tail[q]) - pending[q]
            bump = target - int(pb[q])
            if bump < 0:
                raise ValueError(
                    f"reconcile_crash: queue {q} pointer buffer {int(pb[q])} "
                    f"ahead of target {target} — flush captured a torn "
                    "state?")
            if bump:
                qs.append(q)
                bumps.append(bump)
        if qs:
            dev = state.cpoll.pointer_buffer.device
            state = state._replace(cpoll=cp.doorbell(
                state.cpoll, torch.tensor(qs, dtype=I32, device=dev),
                torch.tensor(bumps, dtype=I32, device=dev),
            ))
            self.counters["doorbells_released"] += len(qs)
        return state, wiped

    @property
    def in_flight(self) -> int:
        """Entries the injector still holds (delayed, not yet landed)."""
        return len(self._delayed)
