"""C3 — the ORCA engine: rings + cpoll + scheduler + APU, one step.

``engine_step`` is the cc-accelerator's main loop (Fig. 3): scan the cpoll
region, schedule round-robin, gather the request batch from the rings
(data-structure walker input), run the application processing unit, write
responses, ring response doorbells. ``run_steps`` drives several steps per
host interaction — the unsignaled-WQE / batched-doorbell analogue.

Apps plug in as ``app_fn(app_state, payloads, valid) -> (app_state,
responses)``; this package provides ``kvstore.app_step``,
``tx_app.app_step`` and ``dlrm.app_step``. This module is the request
half of the JAX package's engine; its LM serving engine is not ported
yet.

Every step is sync-free: no value is read back from the device, so the
host only waits where a caller reads a result.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import cpoll as cp
from repro_torch.core import ringbuf as rb
from repro_torch.core import scheduler as sched
from repro_torch.core import status as st
from repro_torch.core._drop import add_drop, set_drop

I32 = torch.int32


class EngineConfig(NamedTuple):
    num_queues: int = 8
    capacity: int = 64  # ring entries per queue
    req_words: int = 24
    resp_words: int = 24
    budget: int = 32  # APU batch per step (256 outstanding in the paper)
    # APU kernel dispatch: "auto" = the CUDA kernels for CUDA tensors and
    # the plain versions for CPU tensors, "cuda" = the kernels (raises on
    # CPU tensors), "ref" = the plain PyTorch versions on either device.
    kernel_backend: str = "auto"
    # --- deadline-based load shedding (core/status.py vocabulary) ----------
    # deadline_word >= 0 designates that request-payload word as an absolute
    # engine-step deadline (<= 0 in the payload = no deadline). Each step,
    # before budget is spent, the scheduler sheds the doomed prefix of every
    # queue (scheduler.shed_plan): expired entries answer TIMEOUT, entries
    # predicted to expire before they can be served answer SHED — popped and
    # NACKed, never silently dropped. -1 (default) disables the phase.
    deadline_word: int = -1
    # queue-head entries examined by the shed scan per queue (0 = budget)
    shed_scan: int = 0


def _call_app(app_fn: Callable, app, payloads, valid, cfg: EngineConfig):
    """Invoke the APU, threading ``cfg.kernel_backend`` to apps that take
    it (the ``app_step`` of each app module); plain 3-arg closures keep
    their own dispatch defaults."""
    try:
        params = inspect.signature(app_fn).parameters
    except (TypeError, ValueError):  # builtins/partials without signatures
        return app_fn(app, payloads, valid)
    accepts = "kernel_backend" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()
    )
    if accepts:
        return app_fn(app, payloads, valid, kernel_backend=cfg.kernel_backend)
    return app_fn(app, payloads, valid)


def bind_app(app_step: Callable, app_cfg, cfg: EngineConfig, **kw) -> Callable:
    """Bind an app module's ``app_step(state, payloads, valid, app_cfg,
    **kw)`` into the engine's ``app_fn`` shape, carrying the engine's
    kernel_backend knob so ``engine_step``/``run_steps`` dispatch it."""

    def app_fn(state, payloads, valid, *, kernel_backend=cfg.kernel_backend):
        return app_step(
            state, payloads, valid, app_cfg, kernel_backend=kernel_backend, **kw
        )

    return app_fn


class EngineState(NamedTuple):
    """One engine's complete state: the request and response rings, the
    cpoll region, the scheduler, the app's state and four scalar counters
    (all int32). The app state may be updated in place by the app (the KVS
    commits its buckets and pool in place, TX its chain's log and store);
    everything else is new tensors each step."""

    req: rb.RingState
    resp: rb.RingState
    cpoll: cp.CpollState
    sched: sched.SchedState
    app: Any
    steps: torch.Tensor  # () int32
    served: torch.Tensor  # () int32 total requests processed
    timed_out: torch.Tensor  # () int32 requests popped already past deadline
    shed: torch.Tensor  # () int32 requests shed predictively (doomed in queue)


def _device_of(tree):
    """The device of the first tensor in a tree of tensors, (Named)tuples,
    lists and dicts (the DLRM app state is its params dict)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    for x in tree if isinstance(tree, (tuple, list)) else ():
        dev = _device_of(x)
        if dev is not None:
            return dev
    return None


def make(cfg: EngineConfig, app_state, device=None) -> EngineState:
    """Build an engine around ``app_state``. The device is ``device`` if
    given, else the device of the app state's tensors, else CUDA."""
    if device is None:
        device = _device_of(app_state) or "cuda"
    z = lambda: torch.zeros((), dtype=I32, device=device)  # noqa: E731
    return EngineState(
        req=rb.make(cfg.num_queues, cfg.capacity, cfg.req_words, device),
        resp=rb.make(cfg.num_queues, cfg.capacity, cfg.resp_words, device),
        cpoll=cp.make(cfg.num_queues, device),
        sched=sched.make(cfg.num_queues, device),
        app=app_state,
        steps=z(), served=z(), timed_out=z(), shed=z(),
    )


def inject(state: EngineState, queue_ids, payloads, mask=None,
           *, with_accepted: bool = False):
    """Producer path (host/RNIC analogue): write requests + ring doorbells.
    queue_ids must be unique per call (the SPSC contract
    ``ringbuf.enqueue`` enforces); doorbells ring only for entries the ring
    actually accepted, so cpoll never over-reports. ``with_accepted=True``
    returns ``(state, accepted (N,) bool)``."""
    dev = state.req.entries.device
    queue_ids = torch.as_tensor(queue_ids, dtype=I32).to(dev)
    payloads = torch.as_tensor(payloads, dtype=I32).to(dev)
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=torch.bool).to(dev)
    req, accepted = rb.enqueue(state.req, queue_ids, payloads, mask)
    cpo = cp.doorbell(state.cpoll, queue_ids, accepted.to(I32))
    state = state._replace(req=req, cpoll=cpo)
    return (state, accepted) if with_accepted else state


def _shed_phase(state: EngineState, cfg: EngineConfig):
    """Pop + NACK the doomed prefix of every request queue before the
    scheduler spends budget (``scheduler.shed_plan``). Shed responses are
    enqueued ahead of this step's APU responses, and per-queue shed counts
    are clamped by response-ring credit: a shed MUST surface as a
    TIMEOUT/SHED response, so an entry whose NACK cannot land stays
    queued until credit returns."""
    q = cfg.num_queues
    k = cfg.shed_scan or cfg.budget
    dev = state.steps.device
    now = state.steps
    avail = torch.clamp(
        state.cpoll.pointer_buffer - state.cpoll.ring_tracker, 0, cfg.capacity
    )
    offs = torch.arange(k, dtype=I32, device=dev)
    qids = torch.arange(q, dtype=I32, device=dev)
    valid = offs[None, :] < avail[:, None]  # (Q, K)
    entries = rb.peek(
        state.req, qids.repeat_interleave(k), offs.repeat(q)
    ).reshape(q, k, -1)
    deadlines = entries[..., cfg.deadline_word]
    quota = max(cfg.budget // cfg.num_queues, 1)
    counts, prefix, status = sched.shed_plan(deadlines, valid, now, quota)
    counts = torch.minimum(counts, rb.free_slots(state.resp))
    prefix = prefix & (offs[None, :] < counts[:, None])
    req = rb.pop(state.req, qids, counts)
    cpo = cp.cpoll_partial(state.cpoll, qids, counts)
    payload = torch.zeros((q * k, state.resp.entry_words), dtype=I32, device=dev)
    payload[:, 0] = status.reshape(-1)
    resp = _enqueue_multi(
        state.resp, qids.repeat_interleave(k), payload, prefix.reshape(-1)
    )
    n_timeout = torch.sum((prefix & (status == st.TIMEOUT)).to(I32)).to(I32)
    n_shed = torch.sum((prefix & (status == st.SHED)).to(I32)).to(I32)
    state = state._replace(
        req=req, resp=resp, cpoll=cpo,
        timed_out=state.timed_out + n_timeout, shed=state.shed + n_shed,
    )
    return state, n_timeout, n_shed


# App-state scalar counters surfaced as per-step deltas in the engine's
# stats dict when the app carries them (the KVS hot-set cache tier).
_APP_STAT_FIELDS = ("cache_hits", "cache_misses", "cache_evictions")


def _app_stat_deltas(prev_app, new_app):
    """Per-step deltas of the app's counters. The app returns new counter
    tensors (it never bumps them in place), so ``prev_app``'s still hold
    the values from before the step."""
    out = {}
    for name in _APP_STAT_FIELDS:
        before = getattr(prev_app, name, None)
        after = getattr(new_app, name, None)
        if before is not None and after is not None:
            out[name] = after - before
    return out


def engine_step(state: EngineState, app_fn: Callable, cfg: EngineConfig):
    """One APU iteration. Returns (state, stats dict).

    The stats dict always carries ``served``/``backlog``/``timed_out``/
    ``shed``; apps whose state exposes the hot-set cache counters
    additionally report per-step ``cache_hits``/``cache_misses``/
    ``cache_evictions`` deltas."""
    dev = state.steps.device
    # 0. deadline shed phase (only when the config designates a deadline word)
    if cfg.deadline_word >= 0:
        state, n_timeout, n_shed = _shed_phase(state, cfg)
    else:
        n_timeout = torch.zeros((), dtype=I32, device=dev)
        n_shed = torch.zeros((), dtype=I32, device=dev)
    # 1. cpoll: O(4*Q)-byte notification scan
    avail = state.cpoll.pointer_buffer - state.cpoll.ring_tracker
    # 2. round-robin schedule within the step budget
    take, sch = sched.schedule(state.sched, avail, cfg.budget)
    cpo = cp.cpoll_partial(
        state.cpoll, torch.arange(cfg.num_queues, dtype=I32, device=dev), take
    )
    # 3. gather the request batch from ring heads
    qids, counts = sched.selected_queues(take)
    payloads, srcq, valid = rb.gather_batch(state.req, qids, counts, cfg.budget)
    req = rb.pop(state.req, qids, counts)
    # 4. APU (kernel dispatch per cfg.kernel_backend)
    app, responses = _call_app(app_fn, state.app, payloads, valid, cfg)
    # 5. response path (+ response doorbells, batched)
    resp = _enqueue_multi(state.resp, srcq, responses, valid)
    n_served = torch.sum(valid.to(I32)).to(I32)
    new = EngineState(
        req=req, resp=resp, cpoll=cpo, sched=sch, app=app,
        steps=state.steps + 1, served=state.served + n_served,
        timed_out=state.timed_out, shed=state.shed,
    )
    return new, {
        "served": n_served, "backlog": torch.sum(avail - take).to(I32),
        "timed_out": n_timeout, "shed": n_shed,
        **_app_stat_deltas(state.app, app),
    }


def _enqueue_multi(ring: rb.RingState, queue_ids, payloads, mask):
    """Enqueue a batch that may contain several entries per queue (response
    fan-in): per-queue ranks give each entry its own slot. Entries beyond
    a queue's credit are dropped (aimed one row past the rings)."""
    q = ring.num_queues
    ids = torch.where(mask, queue_ids, q)
    rank = rb.rank_within(ids, q + 1)
    ids_c = torch.clamp(ids, 0, q - 1)
    ok = mask & (rb.free_slots(ring)[ids_c] > rank)
    slot = (ring.tail[ids_c] + rank) % ring.capacity
    qq = torch.where(ok, ids, q)
    entries = set_drop(ring.entries, (qq, slot), payloads)
    tail = add_drop(ring.tail, (qq,), 1)
    return rb.RingState(entries, tail, ring.head)


def run_steps(state: EngineState, app_fn: Callable, cfg: EngineConfig, n: int):
    """n engine steps per host interaction — the batched-doorbell analogue.
    Returns (state, stats) with every stats entry stacked to shape (n,)."""
    per_step = []
    for _ in range(n):
        state, stats = engine_step(state, app_fn, cfg)
        per_step.append(stats)
    stacked = {k: torch.stack([s[k] for s in per_step]) for k in per_step[0]}
    return state, stacked


def drain_responses(state: EngineState, max_per_queue: int):
    """Client-side poll: gather+pop up to ``max_per_queue`` responses per
    queue. Returns (payloads (Q, m, W), counts (Q,), state). The client must
    call this to return credit (paper §III-A flow control)."""
    q = state.resp.num_queues
    dev = state.resp.entries.device
    qids = torch.arange(q, dtype=I32, device=dev)
    counts = torch.clamp(rb.available(state.resp), max=max_per_queue)
    offs = torch.arange(max_per_queue, dtype=I32, device=dev)
    payloads = rb.peek(
        state.resp, qids.repeat_interleave(max_per_queue), offs.repeat(q)
    ).reshape(q, max_per_queue, -1)
    payloads = torch.where(
        (offs[None, :] < counts[:, None])[..., None], payloads, 0
    )
    resp = rb.pop(state.resp, qids, counts)
    return payloads, counts, state._replace(resp=resp)
