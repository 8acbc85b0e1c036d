"""Deterministic fault soak: the TX engine under a seeded fault schedule,
checked for conservation and bit-for-bit state agreement with a
never-failed control run.

The port of the JAX package's ``fault/soak.py``; the drivers make the same
numpy draws, so a run here and the JAX run of the same seed inject the
same requests and faults. :func:`run_soak` drives the full request path —
ring inject through ``fault.inject.FaultInjector`` (drop / duplicate /
corrupt / delay / doorbell-suppress), deadline-based shedding in the
engine step, a scheduled mid-chain replica kill + revive with log-replay
resync (``fault.chain``), and a ``request_with_retries``-based client loop
that resubmits NACKed requests — then asserts:

* **conservation** — every entry that landed in a request ring resolves
  to exactly one response (matched FIFO per queue), and every logical
  request ends committed despite drops/corruption/shedding;
* **liveness transparency** — replica death never changes the response
  stream, so the faulted run's status counts equal the control run's;
* **bit-for-bit state** — at the end every replica (survivors AND the
  revived one) equals the control run's replica state exactly;
* **independent store oracle** — queues own disjoint key ranges, so a
  pure-numpy replay of the committed entries must reproduce the store.

:func:`run_overload` is the load-shedding sweep (deadline shedding bounds
the p99 sojourn of served requests; without it the backlog grows).

:func:`run_crash_soak` extends the soak across an engine-death boundary
(``fault.recovery``): the driver flushes durability snapshots/WAL deltas
on a cadence, releases responses only once a committed flush covers their
production (group commit), then tears the engine down mid-run — leaving
a torn ``.tmp`` flush and a torn segment tail behind — and restarts via
``recovery.recover`` + ``FaultInjector.reconcile_crash``. The recovered
state must equal a never-crashed control twin's state at the covered step
bit-for-bit, and every landed request is conserved across the crash.

Release in the crash soaks gates on ``DurabilityManager.settled()``, which
depends on the flush sequence alone. The JAX package's soaks read
``last_committed()`` right after a flush starts its worker, so there what
is released, and with it what the clients resubmit, depends on the
worker thread's timing, and a crashed run and its twin can part.

:func:`run_durability` is the faultless overhead arm: closed-loop load vs
flush cadence, reporting delivery-gated p99 sojourn, throughput, and flush
bytes per step. :func:`run_lm_crash_soak` is the crash soak of the paged
LM engine with a host cold tier.

Every driver runs on ``device`` (the card by default) with the engines'
default ``kernel_backend``, ``auto``: the CUDA kernels on the card, the
plain versions on the CPU.
"""
from __future__ import annotations

import collections
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.checkpoint import wal
from repro_torch.core import engine
from repro_torch.core import kvstore
from repro_torch.core import placement
from repro_torch.core import ringbuf as rb
from repro_torch.core import status as st
from repro_torch.core import transaction as tx
from repro_torch.core import tx_app
from repro_torch.fault import chain as fchain
from repro_torch.fault import inject as finj
from repro_torch.fault import recovery as frec
from repro_torch.fault.inject import NackError, request_with_retries

I32 = torch.int32


def _check(ok, what) -> None:
    """An acceptance check of the soak (kept under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def _step_fns(app_mod, app_cfg, ecfg: engine.EngineConfig):
    app_fn = engine.bind_app(app_mod.app_step, app_cfg, ecfg)
    return (lambda s: engine.engine_step(s, app_fn, ecfg),
            lambda s: engine.drain_responses(s, ecfg.capacity))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _same_trees(a, b, what) -> None:
    """Two host trees equal leaf for leaf, bit for bit."""
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    _check(list(fa) == list(fb), f"{what}: leaves {list(fa)} vs {list(fb)}")
    for k in fa:
        x, y = fa[k], fb[k]
        _check(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x, y), f"{what} at {k}")


def _tx_payload(rng, queue, keys_per_queue, cfg: tx.TxConfig, deadline):
    """One transaction request in the §IV-B log-entry layout plus the
    engine's trailing deadline word. Offsets stay inside the queue's own
    key range so cross-queue commit order cannot matter (the numpy oracle
    replays per-queue FIFO order only)."""
    n = int(rng.integers(1, cfg.max_ops + 1))
    words = [n]
    base = queue * keys_per_queue
    for j in range(cfg.max_ops):
        if j < n:
            words.append(base + int(rng.integers(0, keys_per_queue)))
            words.extend(int(v) for v in
                         rng.integers(1, 2 ** 15, size=cfg.val_words))
        else:
            words.extend([0] * (1 + cfg.val_words))
    words.append(int(deadline))
    return np.asarray(words, np.int64)


def torn_artifacts(directory: str, next_step: int, *, npz: bool = True,
                    segment: bool = True):
    """What a kill mid-flush leaves behind: a torn snapshot attempt (and,
    with ``npz``, a torn one-file delta), plus, with ``segment``, a tail on
    the newest segment whose frame header claims more payload than reached
    the disk. Returns (torn paths, torn segment or None, that segment's
    size before the tear)."""
    tdir = os.path.join(directory, f"step_{next_step}.tmp")
    os.makedirs(tdir, exist_ok=True)
    with open(os.path.join(tdir, "host0.npz"), "wb") as f:
        f.write(b"torn mid-write, no manifest")
    torn = [tdir]
    if npz:
        twal = os.path.join(directory, f"wal_{next_step}.npz.tmp")
        with open(twal, "wb") as f:
            f.write(b"torn delta")
        torn.append(twal)
    segs = wal.list_segments(directory)
    if not (segment and segs):
        return torn, None, None
    seg = segs[-1][1]
    size = os.path.getsize(seg)
    with open(seg, "ab") as f:
        f.write(wal.MAGIC + b"\x40\x00\x00\x00\x00\x00\x00\x00\xde\xad")
    return torn, seg, size


def _drive(seed: int, steps: int, kill, revive, *, num_queues=3,
           keys_per_queue=32, max_ops=3, val_words=2, chain_len=3,
           log_capacity=256, capacity=16, budget=4, deadline_lo=3,
           deadline_hi=16, max_outstanding=5, drain_factor=6,
           durability: Optional[frec.DurabilityConfig] = None,
           crash_at: Optional[int] = None, torn_flush: bool = True,
           control_capture: Optional[int] = None, device="cuda"):
    """One full soak run. Returns a report dict; raises on any
    conservation violation (response with no matching landed entry,
    or a drain that cannot complete).

    With ``durability`` set the driver flushes through a
    ``recovery.DurabilityManager`` every ``durability.every`` engine steps
    (right after the step, before the drain pops — so the flush covers
    this step's productions) and *holds back* popped responses, delivering
    each only once a settled committed flush covers its production
    position (group commit). ``crash_at`` kills the engine at that wall
    step: state is discarded, torn flush artifacts are left behind
    (``torn_flush``), and the run resumes via ``recovery.recover`` +
    ``FaultInjector.reconcile_crash`` + client-side reconciliation.
    ``control_capture`` makes a (non-crashing) run copy its state to the
    host right after the step whose counter equals that value — the
    control twin's bit-for-bit comparison point."""
    tx_cfg = tx.TxConfig(
        num_keys=num_queues * keys_per_queue, val_words=val_words,
        max_ops=max_ops, chain_len=chain_len, log_capacity=log_capacity,
    )
    w = tx_app.request_words(tx_cfg)
    ecfg = engine.EngineConfig(
        num_queues=num_queues, capacity=capacity, req_words=w + 1,
        resp_words=w + 1, budget=budget, deadline_word=w,
    )
    state = engine.make(ecfg, tx.make_chain(tx_cfg, device))
    step_fn, drain_fn = _step_fns(tx_app, tx_cfg, ecfg)
    fi = finj.FaultInjector(finj.FaultConfig(
        seed=seed, p_drop=0.04, p_dup=0.05, p_corrupt=0.05, p_delay=0.07,
        p_suppress=0.05, delay_min=1, delay_max=4, suppress_steps=2,
        kill_schedule=tuple(kill), revive_schedule=tuple(revive),
    ))
    monitor = fchain.ChainMonitor(tx_cfg)
    wl = np.random.default_rng(seed + 1)  # workload stream, fault-independent

    reqs = {}  # uid -> {queue, payload (pristine, no deadline), done, ...}
    outstanding = collections.Counter()  # per queue: requests not done
    fifos = {q: collections.deque() for q in range(num_queues)}
    landed_cursor = 0
    pending = collections.deque()  # uids awaiting (re)submission
    next_uid = 0
    now = 0  # wall clock: survives a crash (client + wire keep ticking)
    engine_now = 0  # tracks state.steps: rolls back to the covered flush
    responses = 0
    status_counts = collections.Counter()
    resubmits = 0
    sojourns = []  # (step_completed, steps_since_first_submit)
    oracle = np.zeros((tx_cfg.num_keys, val_words), np.int64)
    # a send is presumed lost (dropped, or its response shed while we
    # waited) after the worst honest round trip: full queue + max delay +
    # suppressed doorbell + scheduling slack (+ group-commit release lag
    # when responses wait for a covering flush to *fsync*)
    resend_after = capacity + 4 + 2 + 10
    if durability is not None:
        group = durability.group_records if durability.wal == "segment" else 1
        resend_after += (3 + group) * durability.every

    mgr = frec.DurabilityManager(durability) if durability is not None else None
    all_flush_recs = []  # cumulative across a crash (mgr is re-created)
    cov = None  # (Q,) committed production coverage; None = nothing durable
    held = {q: collections.deque() for q in range(num_queues)}  # (pos, row)
    delivered = {q: [] for q in range(num_queues)}  # released rows by position
    popped = {q: 0 for q in range(num_queues)}  # next pop's production position
    applied_events = []  # (step, kind, replica) — re-imposed past the flush
    crash_info = {}
    capture = {}

    def submit(uid):
        nonlocal state
        r = reqs[uid]
        payload = r["payload"].copy()
        # deadlines are engine-clock absolute: the engine compares them to
        # state.steps, which rolls back across a crash with everything else
        payload = np.concatenate([payload, [engine_now + r["deadline_rel"]]])
        state2, acc = fi.inject(state, r["queue"], payload, tag=uid)
        state = state2
        if not acc:
            raise NackError(0, f"ring credit exhausted on queue {r['queue']}")
        r["sent_at"] = now

    def sync_landed():
        nonlocal landed_cursor
        for (_, q, payload, tag) in fi.landed[landed_cursor:]:
            fifos[q].append((tag, payload))
        landed_cursor = len(fi.landed)

    def process_response(q, row):
        """Release one response to the client: FIFO-match it against the
        landed entry at the same per-queue position, account, resubmit on
        NACK. With durability on this runs at *delivery* (covered) time."""
        nonlocal responses
        word0 = int(row[0])
        if not fifos[q]:
            raise AssertionError(
                f"response on queue {q} with no landed entry "
                f"(status {word0})"
            )
        uid, sent = fifos[q].popleft()
        responses += 1
        status_counts[word0] += 1
        r = reqs[uid]
        if word0 == tx_app.RESP_COMMITTED:
            # replay the committed entry (possibly a corrupted or
            # duplicated copy — commit means it validated)
            n = int(sent[0])
            for j in range(n):
                off = int(sent[1 + j * (1 + val_words)])
                vals = sent[2 + j * (1 + val_words):
                            2 + j * (1 + val_words) + val_words]
                oracle[off] = vals
            if not r["done"]:
                sojourns.append((now, now - r["born"]))
                outstanding[r["queue"]] -= 1
            r["done"] = True
        elif not r["done"]:
            # DEFERRED / MALFORMED / SHED / TIMEOUT: resubmit the
            # pristine payload with a fresh deadline
            pending.append(uid)

    def drain():
        nonlocal state
        payloads, counts, state = drain_fn(state)
        payloads = payloads.cpu().numpy()
        counts = counts.cpu().numpy()
        for q in range(num_queues):
            for i in range(int(counts[q])):
                if mgr is None:
                    process_response(q, payloads[q, i])
                else:
                    # group commit: hold the popped row until a committed
                    # flush covers its production position
                    held[q].append((popped[q], payloads[q, i].copy()))
                    popped[q] += 1

    def deliver():
        if mgr is None or cov is None:
            return
        for q in range(num_queues):
            while held[q] and held[q][0][0] < int(cov[q]):
                pos, row = held[q].popleft()
                if pos < len(delivered[q]):
                    # re-surfaced after a crash: the pop was not durable, so
                    # the restored ring re-serves bytes already released —
                    # the position cursor dedupes, and the bytes must match
                    # what the client saw (exactly-once)
                    np.testing.assert_array_equal(row, delivered[q][pos])
                    continue
                delivered[q].append(row)
                process_response(q, row)

    def do_crash():
        """SIGKILL-equivalent engine death + restart-recover-resume."""
        nonlocal state, engine_now, landed_cursor, cov, mgr
        # the kill lands mid-flush: everything submitted before it commits
        # (the worker finishes the rename) and the in-flight write tears —
        # modeled as partially-written artifacts recovery must ignore AND
        # garbage-collect; the kill also tears the streaming WAL mid-append,
        # and recovery must truncate the segment back to the last valid
        # CRC frame, keeping every record the group fsync covered
        mgr.wait()
        torn, torn_seg, seg_size = [], None, None
        if torn_flush:
            torn, torn_seg, seg_size = torn_artifacts(
                durability.directory, engine_now + 1)
        # restart: a fresh process recovers from the NVM tier alone
        like = engine.make(ecfg, tx.make_chain(tx_cfg, device))
        rstats = {}
        _sync(device)
        t0 = time.perf_counter()
        state, covered = frec.recover(durability.directory, like,
                                      stats=rstats)
        _sync(device)
        recover_s = time.perf_counter() - t0
        for p in torn:
            _check(not os.path.exists(p), f"torn artifact survived: {p}")
        if torn_seg is not None:
            _check(os.path.getsize(torn_seg) == seg_size,
                   "recover did not truncate the torn segment tail")
        # capture the pure recover() output NOW — the control twin compares
        # against this, before wire reconciliation re-rings doorbells and
        # post-flush chain events are re-imposed
        recovered_host = ckpt.host_copy(state)
        engine_now = covered
        mgr = frec.DurabilityManager(durability)
        # wire repair: wiped landings returned, withheld doorbells pruned,
        # lost announcements re-rung against the recovered counters
        state, wiped = fi.reconcile_crash(state)
        # client repair: future pops resume at the recovered drain position.
        # A held row the covered flush captured (pos < recovered head) is
        # the only copy and releases below; a later pop rolls back and the
        # row re-surfaces from the restored ring or is re-produced.
        rec_head = state.resp.head.cpu().numpy()
        for q in range(num_queues):
            kept = [(p, row) for (p, row) in held[q] if p < int(rec_head[q])]
            held[q].clear()
            held[q].extend(kept)
            popped[q] = int(rec_head[q])
        # rebuild the per-queue landing FIFOs from the surviving history:
        # everything landed-but-not-yet-released is still awaiting a response
        per_q = {q: [] for q in range(num_queues)}
        for (_, q, payload, tag) in fi.landed:
            per_q[q].append((tag, payload))
        for q in range(num_queues):
            fifos[q] = collections.deque(per_q[q][len(delivered[q]):])
        landed_cursor = len(fi.landed)
        # the recovered snapshot itself is committed coverage
        cov = state.resp.tail.cpu().numpy()
        # chain kill/revive applied after the covered flush died with the
        # engine — re-impose it (kill = mask flip, revive = resync)
        for (t, kind, r) in applied_events:
            if t > covered:
                if kind == "kill":
                    state = state._replace(app=monitor.kill(state.app, r))
                else:
                    state = state._replace(app=monitor.revive(state.app, r))
        # landings wiped by the rollback are provably unanswered (their
        # production was never covered, so never released): crash-NACK and
        # resubmit the pristine payloads
        wiped_resubmitted = 0
        for (_, q, payload, tag) in wiped:
            if not reqs[tag]["done"] and tag not in pending:
                pending.append(tag)
                wiped_resubmitted += 1
        crash_info.update(
            wall_step=now, covered=int(covered), wiped=len(wiped),
            wiped_resubmitted=wiped_resubmitted,
            torn_cleaned=bool(torn),
            torn_segment_truncated=torn_seg is not None,
            recovered_state=recovered_host, recover_s=recover_s,
            snapshot_step=rstats["snapshot_step"],
            wal_records_applied=rstats["wal_records"],
            tx_records_replayed=rstats["tx_records"],
        )
        # release the durably-popped held rows the recovered coverage spans
        deliver()

    def pump_sends():
        nonlocal resubmits
        for _ in range(len(pending)):
            uid = pending.popleft()
            if reqs[uid]["done"]:
                continue
            try:
                request_with_retries(submit, uid, retries=1, backoff=0.0)
                resubmits += reqs[uid]["ever_sent"]
                reqs[uid]["ever_sent"] = 1
            except NackError:
                pending.append(uid)  # no credit: try again next step

    total_steps = 0
    limit = steps * drain_factor

    def one_step(generating: bool):
        nonlocal state, next_uid, now, total_steps, engine_now, cov
        if generating:
            for q in range(num_queues):
                if outstanding[q] < max_outstanding:
                    uid = next_uid
                    next_uid += 1
                    reqs[uid] = {
                        "queue": q,
                        "payload": _tx_payload(wl, q, keys_per_queue, tx_cfg,
                                               0)[:-1],
                        "deadline_rel": int(wl.integers(deadline_lo,
                                                        deadline_hi)),
                        "done": False, "sent_at": now, "ever_sent": 0,
                        "born": now,
                    }
                    outstanding[q] += 1
                    pending.append(uid)
        pump_sends()
        for uid, r in reqs.items():
            if (not r["done"] and uid not in pending
                    and now - r["sent_at"] > resend_after):
                pending.append(uid)
        state, events = fi.tick(state)
        if events:
            state = state._replace(
                app=monitor.apply_events(state.app, events)
            )
            applied_events.extend((fi.now, k, r) for (k, r) in events)
        state, _ = step_fn(state)
        now += 1
        engine_now += 1
        total_steps += 1
        if (control_capture is not None and engine_now == control_capture
                and not capture):
            # the control twin's comparison point: post-step, pre-drain —
            # exactly what a flush at this step captures
            capture["state"] = ckpt.host_copy(state)
        if mgr is not None and engine_now % durability.every == 0:
            all_flush_recs.append(mgr.flush(state))
            # release gates on a settled fsync point: a function of the
            # flush sequence, not of how far the worker thread has got
            lc = mgr.settled()
            if lc is not None:
                cov = lc.resp_tail
        sync_landed()
        drain()
        deliver()

    for _ in range(steps):
        one_step(generating=True)
        if crash_at is not None and now == crash_at and not crash_info:
            do_crash()
    while (pending or fi.in_flight
           or any(fifos[q] for q in fifos)
           or any(held[q] for q in held)
           or not all(r["done"] for r in reqs.values())):
        if total_steps >= limit:
            raise AssertionError(
                f"soak failed to drain in {limit} steps: "
                f"pending={len(pending)} in_flight={fi.in_flight} "
                f"fifo={sum(len(f) for f in fifos.values())} "
                f"held={sum(len(h) for h in held.values())} "
                f"undone={sum(not r['done'] for r in reqs.values())}"
            )
        one_step(generating=False)
    if mgr is not None:
        mgr.wait()

    return {
        "chain": state.app,
        "engine": {
            "steps": int(state.steps), "served": int(state.served),
            "timed_out": int(state.timed_out), "shed": int(state.shed),
        },
        "counters": dict(fi.counters),
        "status_counts": dict(status_counts),
        "responses": responses,
        "resubmits": resubmits,
        "sojourns": sojourns,
        "requests": len(reqs),
        "oracle_store": oracle,
        "monitor_events": list(monitor.events),
        "resync_records": monitor.replayed,
        "flush_records": list(all_flush_recs),
        "flush_bytes": sum(r.bytes for r in all_flush_recs),
        "durability_stats": mgr.stats() if mgr is not None else None,
        "crash": crash_info or None,
        "capture": capture.get("state"),
        "config": {"tx": tx_cfg, "engine": ecfg},
    }


def _check_oracle(report) -> None:
    store = report["chain"].store[0][:-1].cpu().numpy().astype(np.int64)
    _check(np.array_equal(report["oracle_store"], store),
           "the numpy oracle differs from the replica store")


def _check_coverage(main, kill, revive) -> None:
    """Conservation, every fault class fired, the chain failover ran and
    every NACK was recovered."""
    _check(main["responses"] == main["counters"]["landed"],
           (main["responses"], main["counters"]))
    _check(main["requests"] > 0, "no request was made")
    for c in finj.FAULT_CLASSES:
        _check(main["counters"][c] >= 1, (c, main["counters"]))
    _check(("kill", kill[0][1]) in main["monitor_events"],
           main["monitor_events"])
    _check(("revive", revive[0][1]) in main["monitor_events"],
           main["monitor_events"])
    nacks = sum(v for k, v in main["status_counts"].items() if k < 0)
    _check(nacks >= 1, main["status_counts"])
    _check(main["resubmits"] >= 1, "no request was resubmitted")


def _default_schedule(steps, kill, revive):
    if kill is None:
        kill = ((max(steps // 3, 2), 1),)
    if revive is None:
        revive = ((max((2 * steps) // 3, 4), 1),)
    return kill, revive


def run_soak(seed: int = 7, steps: int = 200, *, kill=None, revive=None,
             **kw):
    """Run the faulted soak plus its never-failed control twin and assert
    the full acceptance set (see module docstring). Returns the faulted
    run's report with the control's chain attached."""
    kill, revive = _default_schedule(steps, kill, revive)
    main = _drive(seed, steps, kill, revive, **kw)
    ctrl = _drive(seed, steps, (), (), **kw)
    _check_coverage(main, kill, revive)
    # liveness transparency: response stream identical
    _check(main["status_counts"] == ctrl["status_counts"],
           (main["status_counts"], ctrl["status_counts"]))
    # bit-for-bit state vs the never-failed control
    mc, cc = main["chain"], ctrl["chain"]
    live = mc.live.cpu().numpy()
    _check(live.all(), f"replicas left dead: {live}")
    for r in range(live.shape[0]):
        for f in ("store", "log", "log_tail", "committed"):
            _check(torch.equal(getattr(mc, f)[r], getattr(cc, f)[0]),
                   f"replica {r} {f} differs from the control's")
    _check_oracle(main)
    main["control_chain"] = cc
    return main


def run_crash_soak(seed: int = 11, steps: int = 80, *, crash_at=None,
                   kill=None, revive=None, directory=None, every: int = 2,
                   snapshot_every: int = 8, mode: str = "adaptive",
                   torn_flush: bool = True, segment_bytes: int = 1 << 20,
                   **kw):
    """Crash-restart chaos: the faulted soak with durability flushes, an
    engine kill at wall step ``crash_at`` (leaving torn flush artifacts
    behind), restart-recover-resume, and a never-crashed control twin run
    at the same flush cadence. Asserts, across the crash boundary:

    * ``recover()`` + WAL replay equals the control twin's state at the
      covered step **bit-for-bit** (every leaf of the engine tree);
    * conservation — every landed entry resolves to exactly one released
      response (wiped landings are crash-NACKed and resubmitted; released
      duplicates dedupe byte-equal by position);
    * the torn flush artifacts were ignored AND garbage-collected;
    * every fault class fired, the chain kill/revive happened, and the
      numpy oracle still reproduces the final store.

    Returns the crashed run's report (with ``crash`` details and the
    control twin's durability stats attached). The directory is a fresh
    temporary one unless given, and is removed at the end.
    ``segment_bytes`` is the WAL's segment size: a record larger than it
    rotates the segment, and each rotation is an fsync of its own."""
    kill, revive = _default_schedule(steps, kill, revive)
    if crash_at is None:
        # land mid-flush-window so some landings are past the committed
        # coverage — exercising the wipe + crash-NACK + resubmit path
        crash_at = max(steps // 2, 3)
        if crash_at % every == 0:
            crash_at += 1
    tmp_root = None
    if directory is None:
        tmp_root = tempfile.mkdtemp(prefix="orca-crash-soak-")
        directory = tmp_root
    try:
        dmain, dctrl = (frec.DurabilityConfig(
            os.path.join(directory, name), every=every,
            snapshot_every=snapshot_every, mode=mode,
            segment_bytes=segment_bytes) for name in ("main", "ctrl"))
        main = _drive(seed, steps, kill, revive, durability=dmain,
                      crash_at=crash_at, torn_flush=torn_flush, **kw)
        _check(main["crash"] is not None, "crash never triggered")
        covered = main["crash"]["covered"]
        ctrl = _drive(seed, steps, kill, revive, durability=dctrl,
                      control_capture=covered, **kw)
    finally:
        if tmp_root is not None:
            shutil.rmtree(tmp_root, ignore_errors=True)

    # recovery == never-crashed control at the covered step, bit-for-bit
    _check(ctrl["capture"] is not None,
           "control twin never reached the covered step")
    _same_trees(main["crash"]["recovered_state"], ctrl["capture"],
                "recovered != control")
    _check_coverage(main, kill, revive)
    _check(main["crash"]["torn_cleaned"] == torn_flush,
           "torn artifacts not cleaned")
    if torn_flush and mode != "full" and dmain.wal == "segment":
        # streamed deltas existed, so the kill also tore a segment tail —
        # recovery must have truncated it at the last valid CRC frame
        _check(main["crash"]["torn_segment_truncated"],
               "no torn segment tail was truncated")
    _check(main["crash"]["wiped_resubmitted"] <= main["crash"]["wiped"],
           main["crash"])
    # final state internally consistent: replicas agree, oracle agrees
    mc = main["chain"]
    live = mc.live.cpu().numpy()
    _check(live.all(), f"replicas left dead: {live}")
    for r in range(1, live.shape[0]):
        _check(torch.equal(mc.store[r], mc.store[0]),
               f"replica {r} store differs from replica 0")
    _check_oracle(main)
    main["covered"] = covered
    main["control_resync_records"] = ctrl["resync_records"]
    main["control_durability_stats"] = ctrl["durability_stats"]
    main["control_flush_records"] = ctrl["flush_records"]
    return main


def _durability_app(app: str, num_queues: int, app_cfg, device):
    if app == "tx":
        app_cfg = app_cfg or tx.TxConfig(
            num_keys=num_queues * 32, val_words=2, max_ops=2, chain_len=2,
            log_capacity=1024)
        return app_cfg, tx_app.request_words(app_cfg), tx.make_chain(
            app_cfg, device), tx_app
    if app == "kvs":
        app_cfg = app_cfg or kvstore.KVConfig(
            num_buckets=256, ways=4, key_words=2, val_words=8, pool_size=2048)
        return app_cfg, kvstore.request_words(app_cfg), kvstore.make(
            app_cfg, device), kvstore
    raise ValueError(f"run_durability: unknown app {app!r}")


_NO_DURABILITY = {
    "flush_wait_us": 0.0, "flushes_skipped": 0, "fsyncs": 0,
    "wal_records": 0, "disk_bytes": 0, "gc_removed": 0,
    "host_copy_us": 0.0, "host_copy_bytes": 0,
}


def run_durability(seed: int = 0, steps: int = 160, *, app: str = "tx",
                   durability: Optional[frec.DurabilityConfig] = None,
                   num_queues: int = 4, capacity: int = 64, budget: int = 8,
                   offered_per_queue: int = 2, drain_factor: int = 8,
                   app_cfg=None, device="cuda"):
    """Durability-overhead arm (faultless, closed loop): drive the TX or
    KVS engine under steady offered load with the flush policy of
    ``durability`` (None = durability off), releasing responses only once
    a settled committed flush covers their production — so the reported
    p50/p99 sojourn *includes* the group-commit release lag the flush
    cadence buys, and ``flush_bytes_per_step`` measures what each policy
    ships to the NVM tier. ``app_cfg`` replaces the default (small) TX or
    KVS geometry."""
    app_cfg, w, app_state, app_mod = _durability_app(app, num_queues, app_cfg,
                                                     device)
    ecfg = engine.EngineConfig(
        num_queues=num_queues, capacity=capacity, req_words=w,
        resp_words=w, budget=budget,
    )
    state = engine.make(ecfg, app_state)
    step_fn, drain_fn = _step_fns(app_mod, app_cfg, ecfg)
    wl = np.random.default_rng(seed)
    mgr = frec.DurabilityManager(durability) if durability is not None else None
    qids = np.arange(num_queues, dtype=np.int32)
    fifos = {q: collections.deque() for q in range(num_queues)}  # born steps
    held = {q: collections.deque() for q in range(num_queues)}  # positions
    popped = {q: 0 for q in range(num_queues)}
    cov = None
    responses = 0
    sojourns = []

    def gen_payload(q):
        if app == "tx":
            return _tx_payload(wl, q, 32, app_cfg, 0)[:-1]
        if wl.random() < 0.7:
            vals = wl.integers(1, 2 ** 15, size=app_cfg.val_words)
            op = kvstore.OP_PUT
        else:
            vals = np.zeros((app_cfg.val_words,), np.int64)
            op = kvstore.OP_GET
        key = [q * 64 + int(wl.integers(0, 64)), 7]
        return np.asarray([op, *key, *vals], np.int64)

    def flush_step():
        nonlocal cov
        mgr.flush(state)
        lc = mgr.settled()  # release gates on a settled fsync point
        if lc is not None:
            cov = lc.resp_tail

    def drain_and_deliver(now):
        nonlocal state, responses
        _payloads, counts, state = drain_fn(state)
        counts = counts.cpu().numpy()
        for q in range(num_queues):
            for _ in range(int(counts[q])):
                if mgr is None:
                    born = fifos[q].popleft()
                    responses += 1
                    sojourns.append((now, now - born))
                else:
                    held[q].append(popped[q])
                    popped[q] += 1
        if mgr is not None and cov is not None:
            for q in range(num_queues):
                while held[q] and held[q][0] < int(cov[q]):
                    held[q].popleft()
                    born = fifos[q].popleft()
                    responses += 1
                    sojourns.append((now, now - born))

    now = -1
    for now in range(steps):
        for _ in range(offered_per_queue):
            pays = np.stack([gen_payload(q) for q in range(num_queues)])
            state, acc = engine.inject(
                state, qids, pays.astype(np.int32), with_accepted=True)
            acc = acc.cpu().numpy()
            for q in range(num_queues):
                if acc[q]:
                    fifos[q].append(now)
        state, _ = step_fn(state)
        if mgr is not None and (now + 1) % durability.every == 0:
            flush_step()
        drain_and_deliver(now)
    # drain the backlog, then barrier the final flush so every response is
    # covered and released
    extra = 0
    while any(len(f) for f in fifos.values()):
        if extra > steps * drain_factor:
            raise AssertionError(
                f"durability run failed to drain: "
                f"fifo={sum(len(f) for f in fifos.values())} "
                f"held={sum(len(h) for h in held.values())}"
            )
        state, _ = step_fn(state)
        now += 1
        extra += 1
        flushed = False
        if mgr is not None and (now + 1) % durability.every == 0:
            flush_step()
            flushed = True
        drain_and_deliver(now)
        if mgr is not None and any(len(h) for h in held.values()) and all(
                len(fifos[q]) == len(held[q]) for q in range(num_queues)):
            # the engine is fully drained; only flush coverage is missing —
            # barrier: flush at the final state, join the worker, release
            if not flushed:
                flush_step()
            mgr.wait()  # drains the worker AND forces the group fsync
            cov = mgr.last_committed().resp_tail.copy()
            drain_and_deliver(now)
    if mgr is not None:
        mgr.wait()
    steps_run = now + 1
    tail = [s for (t, s) in sojourns if t >= steps // 2]
    records = mgr.records if mgr else []
    full = sum(1 for r in records if r.kind == "full")
    delta = sum(1 for r in records if r.kind == "delta")
    fbytes = mgr.flush_bytes() if mgr else 0
    stats = mgr.stats() if mgr else dict(_NO_DURABILITY)
    return {
        "app": app,
        "p99_sojourn": float(np.percentile(tail, 99)) if tail else 0.0,
        "p50_sojourn": float(np.percentile(tail, 50)) if tail else 0.0,
        "responses": responses,
        "steps_run": steps_run,
        "throughput_per_step": responses / max(steps_run, 1),
        "flush_count": full + delta,
        "flush_full": full,
        "flush_delta": delta,
        "flush_bytes": fbytes,
        "flush_bytes_per_step": fbytes / max(steps_run, 1),
        "mode": durability.mode if durability else "off",
        "every": durability.every if durability else 0,
        "wal": durability.wal if durability else "off",
        **stats,
        "disk_bytes_per_step": stats["disk_bytes"] / max(steps_run, 1),
        "flush_records": list(records),
    }


def run_overload(seed: int = 0, steps: int = 240, shed: bool = True, *,
                 num_queues: int = 4, capacity: int = 256, budget: int = 8,
                 offered_per_queue: int = 3, deadline: int = 24,
                 shed_scan: int = 32, device="cuda"):
    """Overload sweep arm: offered load ``offered_per_queue`` per queue
    per step against a budget of ``budget // num_queues`` per queue, with
    every request carrying an absolute deadline drawn uniformly from
    ``[deadline/2, 3*deadline/2)`` steps ahead (the variance is what makes
    *predictive* shedding visible). ``shed=True`` enables the engine's
    deadline shed phase; ``shed=False`` runs the same workload with the
    phase disabled. Returns p99/p50 sojourn of served requests over the
    last half of the run, final backlog, and the
    served/shed/timed-out/rejected tallies."""
    tx_cfg = tx.TxConfig(num_keys=num_queues * 32, val_words=1, max_ops=1,
                         chain_len=1, log_capacity=512)
    w = tx_app.request_words(tx_cfg)
    ecfg = engine.EngineConfig(
        num_queues=num_queues, capacity=capacity, req_words=w + 1,
        resp_words=w + 1, budget=budget,
        deadline_word=(w if shed else -1), shed_scan=shed_scan,
    )
    state = engine.make(ecfg, tx.make_chain(tx_cfg, device))
    step_fn, drain_fn = _step_fns(tx_app, tx_cfg, ecfg)
    wl = np.random.default_rng(seed)
    fifos = {q: collections.deque() for q in range(num_queues)}
    sojourns = []  # (step_served, sojourn)
    served = shed_n = timed_out = rejected = 0
    qids = np.arange(num_queues, dtype=np.int32)

    for now in range(steps):
        for _ in range(offered_per_queue):
            pays = np.stack([
                _tx_payload(wl, q, 32, tx_cfg, now + int(wl.integers(
                    max(deadline // 2, 1), deadline + deadline // 2)))
                for q in range(num_queues)
            ])
            state, acc = engine.inject(
                state, qids, pays.astype(np.int32), with_accepted=True)
            acc = acc.cpu().numpy()
            for q in range(num_queues):
                if acc[q]:
                    fifos[q].append(now)
                else:
                    rejected += 1
        state, _ = step_fn(state)
        payloads, counts, state = drain_fn(state)
        payloads = payloads.cpu().numpy()
        counts = counts.cpu().numpy()
        for q in range(num_queues):
            for i in range(int(counts[q])):
                word0 = int(payloads[q, i, 0])
                born = fifos[q].popleft()
                if word0 == tx_app.RESP_COMMITTED:
                    served += 1
                    sojourns.append((now, now - born))
                elif word0 == st.SHED:
                    shed_n += 1
                elif word0 == st.TIMEOUT:
                    timed_out += 1
    tail = [s for (t, s) in sojourns if t >= steps // 2]
    backlog = int((state.cpoll.pointer_buffer
                   - state.cpoll.ring_tracker).sum())
    return {
        "p99_sojourn": float(np.percentile(tail, 99)) if tail else float("inf"),
        "p50_sojourn": float(np.percentile(tail, 50)) if tail else float("inf"),
        "served": served, "shed": shed_n, "timed_out": timed_out,
        "rejected": rejected, "final_backlog": backlog,
        "steps": steps, "deadline": deadline,
    }


# ---------------------------------------------------------------------------
# LM crash soak: paged decode + host cold tier in the persistence domain
# ---------------------------------------------------------------------------

#: the JAX package's LM crash-soak engine (reduced model, tiny pool, a host
#: tier that must take evictions)
LM_SOAK_ENGINE = engine.LMEngineConfig(
    num_queues=2, capacity=8, prompt_len=4, gen_len=6, slots=3,
    admit_per_step=2, cache_len=16, paged=True, page_size=2,
    num_pages=8, host_pages=10, expected_gen_len=3)


def lm_soak_model(seed: int, device="cuda"):
    """(model config, context, params) of the LM crash soak: the reduced
    f32 qwen1.5-0.5b with random parameters from ``seed``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import local_context

    cfg = reduced(get_config("qwen1.5-0.5b")).replace(dtype="float32")
    ctx = local_context()
    return cfg, ctx, init_params(seed, cfg, ctx, device)


def _drive_lm(seed: int, steps: int, *, ecfg: engine.LMEngineConfig,
              durability: frec.DurabilityConfig, n_requests: int, model,
              device="cuda", crash: bool = False,
              crash_at: Optional[int] = None, control_capture=None,
              torn_flush: bool = True):
    """One LM serving timeline with durable flushes; optionally crash once.
    ``model`` is (model config, context, params).

    The client half mirrors ``_drive``'s release discipline: a response row
    is *delivered* only once a settled committed flush covers its ring
    position, so both twins pop rings identically and the recovered engine
    state is bit-for-bit the control twin's state at the covered step.
    Rows that re-surface after the crash rewind (position below the
    delivered high-water mark) must be byte-identical to the first
    delivery — exactly-once.
    """
    cfg, ctx, params = model

    def step_fn(s):
        return engine.lm_engine_step(s, ecfg, cfg, ctx, params)

    budget = swap = cold = None
    if ecfg.host_pages:
        from repro_torch.models.layers import dtype_of

        pcfg = engine.lm_paged_kv_config(ecfg, cfg, ctx)
        page_b = (2 * pcfg.layers * pcfg.page_size * pcfg.kv_heads
                  * pcfg.head_dim * dtype_of(cfg.dtype).itemsize)
        budget = placement.MemoryBudget(
            dram_bytes=ecfg.host_pages * page_b, nvm_bytes=1 << 30)
        # the tier object survives the crash below: recover() restores the
        # parked slabs into it from the snapshot+WAL stream
        swap, cold, _ = engine.make_swap_service(ecfg, cfg, ctx,
                                                 budget=budget)
    mgr = frec.DurabilityManager(durability, budget=budget, cold=cold)
    stats_acc = dict(_NO_DURABILITY)

    def acc_stats():
        for k, v in mgr.stats().items():
            stats_acc[k] += v

    nq = ecfg.num_queues
    wl = np.random.default_rng(seed + 1000)
    prompts = wl.integers(
        1, cfg.vocab_size, size=(n_requests, ecfg.prompt_len)).astype(np.int32)
    caps = wl.integers(1, ecfg.gen_len + 1, size=n_requests).astype(np.int32)
    arrive = np.sort(wl.integers(0, max(steps // 3, 1), size=n_requests))
    queue_of = np.arange(n_requests) % nq
    target = {q: int((queue_of == q).sum()) for q in range(nq)}

    pend = {q: collections.deque() for q in range(nq)}
    sent = {q: [] for q in range(nq)}  # rids in ring order (abs position)
    delivered = {q: {} for q in range(nq)}  # abs ring position -> row copy
    state = engine.lm_make_paged(ecfg, cfg, ctx, device)
    engine_now = 0
    next_arrival = 0
    cov = None
    flush_recs = []
    capture = {}
    crash_info = {}

    def inject(t):
        nonlocal state, next_arrival
        while next_arrival < n_requests and arrive[next_arrival] <= t:
            pend[int(queue_of[next_arrival])].append(next_arrival)
            next_arrival += 1
        free = rb.free_slots(state.req).cpu().numpy()
        qids, rows, cs = [], [], []
        for q in range(nq):
            if pend[q] and free[q] > 0:
                r = pend[q].popleft()
                qids.append(q)
                rows.append(prompts[r])
                cs.append(int(caps[r]))
                sent[q].append(r)
        if qids:
            state = engine.lm_inject(state, qids, np.stack(rows), gen_caps=cs)

    def deliver():
        nonlocal state
        if cov is None:
            return
        heads = state.resp.head.cpu().numpy()
        avail = rb.available(state.resp).cpu().numpy()
        ents = state.resp.entries.cpu().numpy()
        cap_r = ents.shape[1]
        counts = np.zeros(nq, np.int32)
        for q in range(nq):
            lim = max(0, min(int(avail[q]), int(cov[q]) - int(heads[q])))
            for j in range(lim):
                pos = int(heads[q]) + j
                ent = ents[q, pos % cap_r].copy()
                if pos in delivered[q]:
                    # replayed after the crash rewind: byte-identical or bust
                    _check(np.array_equal(delivered[q][pos], ent),
                           f"queue {q} pos {pos}: replayed response diverged")
                else:
                    delivered[q][pos] = ent
            counts[q] = lim
        if counts.sum():
            dev = state.resp.head.device
            state = state._replace(resp=rb.pop(
                state.resp, torch.arange(nq, dtype=I32, device=dev),
                torch.from_numpy(counts).to(dev)))

    def tick(t):
        nonlocal state, engine_now, cov
        inject(t)
        state = step_fn(state)
        if swap is not None:
            state = swap(state)
        engine_now += 1
        if control_capture is not None and engine_now == control_capture \
                and not capture:
            # same site as the flush's host copy: post-step, post-swap,
            # pre-delivery — what recover() must reproduce bit-for-bit
            capture["engine"] = ckpt.host_copy(state)
            if cold is not None:
                capture["cold"] = cold.state_arrays()
        if engine_now % durability.every == 0:
            flush_recs.append(mgr.flush(state))
            lc = mgr.settled()
            if lc is not None:
                cov = lc.resp_tail.copy()
        deliver()

    def do_crash():
        nonlocal state, mgr, cov, engine_now
        mgr.wait()
        d = durability.directory
        # kill artifacts: a torn snapshot attempt and a torn segment tail
        torn, torn_seg, seg_size = torn_artifacts(
            d, engine_now + 1, npz=False, segment=torn_flush)
        acc_stats()
        like = engine.lm_make_paged(ecfg, cfg, ctx, device)
        rstats = {}
        _sync(device)
        t0 = time.perf_counter()
        state, covered = frec.recover(d, like, cold=cold, stats=rstats)
        _sync(device)
        crash_info["recover_s"] = time.perf_counter() - t0
        crash_info["wal_records_applied"] = rstats["wal_records"]
        _check(not os.path.exists(torn[0]),
               "recover left the torn .tmp behind")
        if torn_seg is not None:
            _check(os.path.getsize(torn_seg) == seg_size,
                   "recover did not truncate the torn segment tail")
        crash_info["covered"] = int(covered)
        crash_info["torn_segment_truncated"] = torn_seg is not None
        crash_info["recovered_engine"] = ckpt.host_copy(state)
        if cold is not None:
            crash_info["recovered_cold"] = cold.state_arrays()
        engine_now = int(covered)
        mgr = frec.DurabilityManager(durability, budget=budget, cold=cold)
        # client reconciliation against the rewound rings: requests past
        # the recovered req tail were wiped — re-queue them, in order,
        # ahead of arrivals not yet injected
        req_tail = state.req.tail.cpu().numpy()
        for q in range(nq):
            wiped = sent[q][int(req_tail[q]):]
            sent[q] = sent[q][:int(req_tail[q])]
            for r in reversed(wiped):
                pend[q].appendleft(r)
        cov = state.resp.tail.cpu().numpy()
        deliver()

    t = 0
    limit = steps + n_requests * (ecfg.gen_len + 24)
    while any(len(delivered[q]) < target[q] for q in range(nq)):
        _check(t < limit,
               f"LM soak failed to drain: "
               f"{[len(delivered[q]) for q in range(nq)]} of {target}")
        tick(t)
        tails = state.resp.tail.cpu().numpy()
        if crash and not crash_info:
            # fire by wall tick when pinned, else once half the requests
            # have *completed* (response enqueued) — mid-decode whatever
            # the delivery pacing
            fire = (t == crash_at) if crash_at is not None else (
                int(tails.sum()) >= max(1, n_requests // 2))
            if fire:
                do_crash()
                crash_info["tick"] = t
                tails = state.resp.tail.cpu().numpy()
        if all(int(tails[q]) >= target[q] for q in range(nq)) \
                and any(len(delivered[q]) < target[q] for q in range(nq)):
            # all responses exist in the rings; force the trailing group
            # commit so coverage catches up and the rings drain
            flush_recs.append(mgr.flush(state))
            mgr.wait()
            cov = mgr.last_committed().resp_tail.copy()
            deliver()
        t += 1
    mgr.wait()
    acc_stats()

    return {
        "delivered": delivered,
        "target": target,
        "capture": capture or None,
        "crash": crash_info or None,
        "flush_records": flush_recs,
        "durability_stats": stats_acc,
        "evictions": int(cold.evictions) if cold is not None else 0,
        "restores": int(cold.restores) if cold is not None else 0,
        "budget_refusals": int(cold.budget_refusals) if cold is not None else 0,
        "dir_entries": sorted(os.listdir(durability.directory)),
        "wall_ticks": t,
    }


def run_lm_crash_soak(seed: int = 3, steps: int = 36, *,
                      crash_at: Optional[int] = None, directory=None,
                      every: int = 2, snapshot_every: int = 32,
                      mode: str = "delta", group_records: int = 4,
                      n_requests: int = 10, torn_flush: bool = True,
                      segment_bytes: int = 1 << 20,
                      ecfg: Optional[engine.LMEngineConfig] = None,
                      model=None, device="cuda",
                      twin_backend: Optional[str] = None):
    """Crash soak for the paged LM engine with a host cold tier.

    Teardown mid-decode (torn snapshot .tmp + torn streaming-WAL segment
    tail), recovery replays snapshot + WAL deltas — including dirty KV
    pages and the cold tier's parked slabs — to the covered step, and the
    surviving timeline must match a never-crashed control twin:

    - recovered engine state (page pool, rings, slots) and cold-tier
      arrays are **bit-for-bit** the control twin's state at the covered
      step;
    - per-queue delivered token rows are the same multiset, byte-exact
      (every request's token stream identical, delivered exactly once);
    - the torn segment tail was truncated at the last valid CRC frame;
    - group commit did its job: strictly fewer fsyncs than WAL records;
    - the cold tier took evictions;
    - with ``twin_backend`` (say ``"ref"``), a third, never-crashed
      timeline whose engine dispatches to that backend delivers the same
      token rows at the same ring positions as the control twin: the
      kernels held against their plain versions at this run's shapes.

    ``ecfg`` defaults to :data:`LM_SOAK_ENGINE`, ``model`` (model config,
    context, params) to :func:`lm_soak_model` of ``seed``;
    ``segment_bytes`` is the WAL's segment size (a record past it rotates
    the segment, an fsync of its own), as in :func:`run_crash_soak`."""
    ecfg = ecfg or LM_SOAK_ENGINE
    model = model or lm_soak_model(seed, device)
    tmp = None
    if directory is None:
        tmp = tempfile.mkdtemp(prefix="orca_lm_soak_")
        directory = tmp
    try:
        dmain, dctrl = (frec.DurabilityConfig(
            os.path.join(directory, name), every=every,
            snapshot_every=snapshot_every, mode=mode,
            group_records=group_records, segment_bytes=segment_bytes)
            for name in ("main", "ctrl"))
        seconds = {}
        _sync(device)
        t0 = time.perf_counter()
        main = _drive_lm(seed, steps, ecfg=ecfg, durability=dmain,
                         n_requests=n_requests, model=model, device=device,
                         crash=True, crash_at=crash_at,
                         torn_flush=torn_flush)
        _check(main["crash"] is not None, "crash arm never fired")
        covered = main["crash"]["covered"]
        _sync(device)
        seconds["main"] = time.perf_counter() - t0
        ctrl = _drive_lm(seed, steps, ecfg=ecfg, durability=dctrl,
                         n_requests=n_requests, model=model, device=device,
                         control_capture=covered)
        _sync(device)
        seconds["ctrl"] = time.perf_counter() - t0 - seconds["main"]
        twin = None
        if twin_backend is not None:
            dtwin = dctrl._replace(directory=os.path.join(directory, "twin"))
            twin = _drive_lm(
                seed, steps, ecfg=ecfg._replace(kernel_backend=twin_backend),
                durability=dtwin, n_requests=n_requests, model=model,
                device=device)
            _sync(device)
            seconds["twin"] = (time.perf_counter() - t0 - seconds["main"]
                               - seconds["ctrl"])
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    # 1) recovery lands exactly on the control twin's covered state
    _check(ctrl["capture"], "control twin never reached the covered step")
    _same_trees(main["crash"]["recovered_engine"], ctrl["capture"]["engine"],
                "recovered LM engine state != control twin")
    if "recovered_cold" in main["crash"]:
        _same_trees(main["crash"]["recovered_cold"], ctrl["capture"]["cold"],
                    "recovered cold tier != control twin")
    if torn_flush and mode != "full" and dmain.wal == "segment":
        _check(main["crash"]["torn_segment_truncated"],
               "crash never left a torn segment tail to truncate")

    # 2) per-queue token streams: same multiset, byte-exact, exactly once
    for q in range(ecfg.num_queues):
        _check(len(main["delivered"][q]) == main["target"][q]
               and len(ctrl["delivered"][q]) == main["target"][q],
               f"queue {q}: not every request delivered")
        ms = sorted(tuple(int(x) for x in row)
                    for row in main["delivered"][q].values())
        cs_ = sorted(tuple(int(x) for x in row)
                     for row in ctrl["delivered"][q].values())
        _check(ms == cs_,
               f"queue {q}: delivered token rows diverged from control")

    if twin is not None:
        for q in range(ecfg.num_queues):
            dc, dt = ctrl["delivered"][q], twin["delivered"][q]
            _check(dc.keys() == dt.keys()
                   and all(np.array_equal(dc[p], dt[p]) for p in dc),
                   f"queue {q}: {twin_backend} twin's token rows differ "
                   f"from the control twin's")

    # 3) group commit amortized durability: fewer fsyncs than records
    st_main = main["durability_stats"]
    if mode != "full" and dmain.wal == "segment":
        _check(st_main["wal_records"] >= group_records,
               f"only {st_main['wal_records']} WAL records")
        _check(st_main["fsyncs"] < st_main["wal_records"],
               f"group commit missing: {st_main['fsyncs']} fsyncs for "
               f"{st_main['wal_records']} WAL records")

    # 4) the cold tier actually took part (mid-decode oversubscription)
    _check(main["evictions"] >= 1, "soak never exercised the cold tier")

    return {"main": main, "ctrl": ctrl, "twin": twin, "covered": covered,
            "seconds": seconds,
            "ecfg": ecfg._asdict(),
            "crash_at": main["crash"].get("tick", crash_at),
            "stats": st_main}
