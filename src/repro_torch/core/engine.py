"""C3 — the ORCA engine: rings + cpoll + scheduler + APU, one step.

``engine_step`` is the cc-accelerator's main loop (Fig. 3): scan the cpoll
region, schedule round-robin, gather the request batch from the rings
(data-structure walker input), run the application processing unit, write
responses, ring response doorbells. ``run_steps`` drives several steps per
host interaction — the unsignaled-WQE / batched-doorbell analogue.

Apps plug in as ``app_fn(app_state, payloads, valid) -> (app_state,
responses)``; this package provides ``kvstore.app_step``,
``tx_app.app_step`` and ``dlrm.app_step``. The LM serving engine below
specialises the same loop for continuous-batching token generation
(requests = prompts, responses = generated sequences), decoding through
dense per-slot ring caches or, with ``LMEngineConfig.paged``, through the
shared page pool of ``serving/kv_cache.py`` and its CUDA paged-attention
kernel.

Every request-engine step is sync-free: no value is read back from the
device, so the host only waits where a caller reads a result. The paged
LM step reads one count back (how many admitted prompts to prefill).
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, NamedTuple

import numpy as np
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


# ---------------------------------------------------------------------------
# LM serving engine: continuous batching on top of the same loop
# ---------------------------------------------------------------------------

class LMEngineConfig(NamedTuple):
    num_queues: int = 4
    capacity: int = 16
    prompt_len: int = 16  # fixed prompt words per request
    # gen_len is the per-request *cap* (and the response-payload width): a
    # request carries its own cap <= gen_len in its last payload word, and
    # EOS can end it earlier still.
    gen_len: int = 16
    slots: int = 8  # continuous-batching slots
    admit_per_step: int = 2  # prefill admissions per step
    cache_len: int = 64  # dense path: per-slot ring-cache length
    # a slot whose last emitted token equals eos_token completes (-1: off)
    eos_token: int = -1
    # --- paged decode path (serving/kv_cache shared page pool) ------------
    paged: bool = False
    page_size: int = 8  # tokens per KV page
    num_pages: int = 0  # pool size; 0 = worst case (slots x pages/request)
    # --- host cold tier (device <-> host page swap) ------------------------
    # host_pages > 0 attaches a kv_cache.HostColdTier and switches admission
    # credit from worst-case pages to expected-live pages against the total
    # hot + cold budget: the pool may be oversubscribed, a slot whose page
    # allocation finds the pool dry stalls (slot_stalled), and the swap
    # service evicts a victim to the host tier.
    host_pages: int = 0
    # expected generated tokens under EOS for the credit math (0 = gen_len)
    expected_gen_len: int = 0
    # kernel dispatch for the page walk and the flash prefill: auto | cuda
    # | ref (see EngineConfig)
    kernel_backend: str = "auto"


class LMEngineState(NamedTuple):
    req: rb.RingState
    resp: rb.RingState
    cpoll: cp.CpollState
    sched: sched.SchedState
    decode: Any  # models.DecodeState, or kv_cache.PagedKVState when paged
    slot_active: torch.Tensor  # (N,) bool
    slot_queue: torch.Tensor  # (N,) source queue (-1 free)
    slot_done: torch.Tensor  # (N,) tokens generated so far
    slot_out: torch.Tensor  # (N, gen_len) generated tokens
    slot_last: torch.Tensor  # (N,) last token (next decode input)
    slot_cap: torch.Tensor  # (N,) this request's generation cap
    slot_stalled: torch.Tensor  # (N,) bool: pool was dry for its page
    steps: torch.Tensor
    completed: torch.Tensor


def lm_make(cfg: LMEngineConfig, decode_state, device=None) -> LMEngineState:
    """Engine state around a decode substrate (on its device unless
    ``device`` says otherwise)."""
    if device is None:
        device = _device_of(decode_state) or "cuda"
    n = cfg.slots
    z = lambda *shape, dtype=I32, fill=0: torch.full(  # noqa: E731
        shape, fill, dtype=dtype, device=device)
    return LMEngineState(
        # request entries carry the prompt plus a trailing cap word;
        # response entries lead with a generated-token count
        req=rb.make(cfg.num_queues, cfg.capacity, cfg.prompt_len + 1, device),
        resp=rb.make(cfg.num_queues, cfg.capacity, cfg.gen_len + 1, device),
        cpoll=cp.make(cfg.num_queues, device),
        sched=sched.make(cfg.num_queues, device),
        decode=decode_state,
        slot_active=z(n, dtype=torch.bool, fill=False),
        slot_queue=z(n, fill=-1),
        slot_done=z(n),
        slot_out=z(n, cfg.gen_len),
        slot_last=z(n),
        slot_cap=z(n, fill=cfg.gen_len),
        slot_stalled=z(n, dtype=torch.bool, fill=False),
        steps=z(),
        completed=z(),
    )


def lm_max_pages_per_request(cfg: LMEngineConfig) -> int:
    """Worst-case pages a request holds: the prompt plus every decoded
    token's kv but the last (never stored: never attended)."""
    tokens = cfg.prompt_len + max(cfg.gen_len - 1, 1)
    return -(-tokens // cfg.page_size)


def lm_expected_pages_per_request(cfg: LMEngineConfig) -> int:
    """Expected live pages per request under EOS/cap termination: the
    credit unit when the pool is oversubscribed against a host tier."""
    gen = cfg.expected_gen_len or cfg.gen_len
    gen = min(max(gen, 1), cfg.gen_len)
    tokens = cfg.prompt_len + max(gen - 1, 1)
    return -(-tokens // cfg.page_size)


def lm_paged_kv_config(cfg: LMEngineConfig, model_cfg, ctx):
    """PagedKVConfig for this engine + model (the pool auto-sized to the
    dense-equivalent worst case when ``cfg.num_pages`` is 0); under
    tensor parallelism this rank's pool, its kv heads. Over data ranks
    every rank's pool has every page (the allocator is one), and holds
    the data of its slots' pages only."""
    from repro_torch.models.model import make_paged_kv_config

    mppr = lm_max_pages_per_request(cfg)
    num_pages = cfg.num_pages or cfg.slots * mppr
    if num_pages < mppr:
        raise ValueError(
            f"num_pages={num_pages} cannot hold even one request at its "
            f"gen_len={cfg.gen_len} cap ({mppr} pages at page_size="
            f"{cfg.page_size}); admission credit would be 0 forever"
        )
    if cfg.host_pages and cfg.host_pages < (cfg.slots - 1) * mppr:
        raise ValueError(
            f"host_pages={cfg.host_pages} cannot park {cfg.slots - 1} "
            f"worst-case victims ({(cfg.slots - 1) * mppr} pages): with "
            f"every slot stalled the swap service must be able to evict "
            f"all but one runner, or the engine deadlocks"
        )
    return make_paged_kv_config(
        model_cfg, ctx, num_pages=num_pages, page_size=cfg.page_size,
        max_pages_per_seq=mppr,
    )


def lm_make_paged(cfg: LMEngineConfig, model_cfg, ctx,
                  device="cuda") -> LMEngineState:
    """Engine state whose decode side is the shared page pool."""
    from repro_torch.models.layers import dtype_of
    from repro_torch.serving import kv_cache as pk

    pcfg = lm_paged_kv_config(cfg, model_cfg, ctx)
    kv = pk.make(pcfg, batch=cfg.slots, dtype=dtype_of(model_cfg.dtype),
                 device=device)
    return lm_make(cfg, kv, device)


def lm_inject(state: LMEngineState, queue_ids, prompts, mask=None,
              gen_caps=None) -> LMEngineState:
    """Enqueue requests. ``prompts`` is (n, prompt_len); the optional
    ``gen_caps`` (n,) rides in the entry's trailing cap word (0 = the
    ``gen_len`` default; the engine clips to [1, gen_len])."""
    dev = state.req.entries.device
    queue_ids = torch.as_tensor(queue_ids, dtype=I32).to(dev)
    prompts = torch.as_tensor(prompts, dtype=I32).to(dev)
    n = queue_ids.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.bool).to(dev)
    if prompts.shape[-1] == state.req.entry_words - 1:
        caps = (torch.zeros((n,), dtype=I32, device=dev) if gen_caps is None
                else torch.as_tensor(gen_caps, dtype=I32).to(dev))
        prompts = torch.cat([prompts, caps[:, None]], dim=1)
    req, accepted = rb.enqueue(state.req, queue_ids, prompts, mask)
    cpo = cp.doorbell(state.cpoll, queue_ids, accepted.to(I32))
    return state._replace(req=req, cpoll=cpo)


def _lm_terminal(cfg: LMEngineConfig, done, cap, last):
    """Per-slot terminal predicate: the request hit its cap, or it has
    emitted a token and the latest is ``eos_token``. Evaluated before the
    decode (eligibility) and after it (completion)."""
    term = done >= cap
    if cfg.eos_token >= 0:
        term = term | ((done > 0) & (last == cfg.eos_token))
    return term


def lm_engine_step(state: LMEngineState, cfg: LMEngineConfig, model_cfg, ctx,
                   params, prefill_fn=None, decode_fn=None):
    """Decode one token for every eligible slot, complete finished
    requests into the response rings, admit queued prompts into the freed
    slots (prefill). ``cfg.paged`` selects the decode substrate: dense
    per-slot ring caches (``prefill_fn``/``decode_fn`` required) or the
    shared page pool (``prefill_fn`` optionally overrides
    ``models.prefill_kv``; it gets the admitted prompts only, so for an
    MoE model it must size the capacity from the padded batch itself)."""
    if cfg.paged:
        return _lm_step_paged(state, cfg, model_cfg, ctx, params, prefill_fn)
    if prefill_fn is None or decode_fn is None:
        raise ValueError("dense lm_engine_step needs prefill_fn and decode_fn")
    return _lm_step_dense(state, cfg, model_cfg, ctx, params, prefill_fn,
                          decode_fn)


def _argmax(logits):
    """Greedy token: ties go to the lowest index, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(I32)


# The engine over data ranks. Every rank holds the integer state whole
# (rings, scheduler, slots, positions, responses; the page pool's
# allocator) and takes every decision; the decode state is split by
# slot rows as ``model.decode_state_specs`` splits it (``model.
# batch_rows``: a block a rank when the data axes divide the slots, else
# replicated). A decode step runs on the rank's rows and the ranks'
# greedy tokens are gathered, so every rank records the whole batch. An
# admission prefill runs the whole padded batch on every rank
# (``model.whole_batch``: an MoE block's capacity and dispatch are the
# whole batch's, as GSPMD's, with no collective), and each rank keeps
# the rows that land in its slots.

def _greedy(logits, rows: slice, batch: int, ctx):
    """The whole batch's greedy tokens from this rank's ``rows`` of the
    logits: gathered over the data axes when they split the batch."""
    from repro_torch.parallel import collectives as coll

    nxt = _argmax(logits)
    return nxt if rows == slice(0, batch) else coll.data_gather(nxt, ctx)


def _local_slots(slot_tgt, rows: slice):
    """Global target slots as indices into a rank's ``rows`` (``N_loc``,
    dropped, for a slot another rank holds or none)."""
    n = rows.stop - rows.start
    t = slot_tgt - rows.start
    return torch.where((t >= 0) & (t < n), t, n)


def admission_blocks(n_rows: int, model_cfg, ctx) -> list:
    """The row blocks an admission prefill of ``n_rows`` runs in, each
    on the whole-batch context: one, unless the EP shard_map dispatch
    runs over data ranks, where JAX's ``shard_map`` gives each data rank
    its block of the padded batch (its send buffers sized from it), so
    every rank prefills the ``dp`` blocks one by one."""
    from repro_torch.parallel import collectives as coll

    if not (model_cfg.is_moe and ctx.ep_shardmap
            and coll.data_parallel(ctx)):
        return [slice(0, n_rows)]
    if n_rows % ctx.dp:
        raise ValueError(f"the EP shard_map dispatch splits {n_rows} "
                         f"admitted rows over {ctx.dp} data ranks")
    n = n_rows // ctx.dp
    return [slice(i * n, (i + 1) * n) for i in range(ctx.dp)]


def _record(state, cfg, eligible, nxt):
    """Write ``nxt`` at each eligible slot's next output position."""
    write_pos = torch.clamp(state.slot_done, 0, cfg.gen_len - 1).long()
    onehot = (torch.arange(cfg.gen_len, device=nxt.device)[None, :]
              == write_pos[:, None]) & eligible[:, None]
    slot_out = torch.where(onehot, nxt[:, None], state.slot_out)
    slot_done = state.slot_done + eligible.to(I32)
    slot_last = torch.where(eligible, nxt, state.slot_last)
    return slot_out, slot_done, slot_last


def _complete(state, cfg, finished, slot_done, slot_out):
    """Responses ``[count | tokens...]`` of finished slots into the rings,
    and the freed slots' bookkeeping."""
    payload = torch.cat([slot_done[:, None], slot_out], dim=1)
    resp = _enqueue_multi(
        state.resp, torch.clamp(state.slot_queue, 0, cfg.num_queues - 1),
        payload, finished,
    )
    return (resp, state.slot_active & ~finished,
            torch.where(finished, -1, state.slot_queue),
            torch.where(finished, 0, slot_done),
            torch.where(finished, cfg.gen_len, state.slot_cap),
            state.completed + torch.sum(finished.to(I32)).to(I32))


def _admission(state, cfg, slot_active, budget):
    """Pop up to ``budget`` (a tensor) prompts, round-robin over queues.
    Returns (req, cpoll, sched, prompts, caps, srcq, valid, slot_ids)."""
    dev = slot_active.device
    avail = state.cpoll.pointer_buffer - state.cpoll.ring_tracker
    take, sch = sched.schedule(state.sched, avail, cfg.admit_per_step)
    cum = torch.cumsum(take, 0, dtype=I32)
    take = torch.where(cum <= budget, take,
                       torch.clamp(take - (cum - budget), min=0)).to(I32)
    cpo = cp.cpoll_partial(
        state.cpoll, torch.arange(cfg.num_queues, dtype=I32, device=dev), take)
    qids, counts = sched.selected_queues(take)
    payloads, srcq, valid = rb.gather_batch(state.req, qids, counts,
                                            cfg.admit_per_step)
    req = rb.pop(state.req, qids, counts)
    prompts = payloads[:, :cfg.prompt_len]
    cap_word = payloads[:, cfg.prompt_len]
    caps = torch.clamp(torch.where(cap_word > 0, cap_word, cfg.gen_len), 1,
                       cfg.gen_len).to(I32)
    # target slots: the first admit_per_step free slots, by index
    slot_ids = torch.argsort(slot_active.to(torch.int8), stable=True)[
        :cfg.admit_per_step].to(I32)
    return req, cpo, sch, prompts, caps, srcq, valid, slot_ids


def _seat(cfg, slot_tgt, admit_ok, srcq, caps, adm_next, slot_active,
          slot_queue, slot_done, slot_last, slot_cap, slot_out):
    """Seat admitted requests in their slots (``slot_tgt == N``: none)."""
    idx = (slot_tgt.long(),)
    slot_active = set_drop(slot_active, idx, True)
    slot_queue = set_drop(slot_queue, idx, torch.where(admit_ok, srcq, -1))
    slot_done = set_drop(slot_done, idx, 1)
    slot_last = set_drop(slot_last, idx, adm_next)
    slot_cap = set_drop(slot_cap, idx, caps)
    first = torch.zeros((slot_tgt.shape[0], cfg.gen_len), dtype=I32,
                        device=slot_tgt.device)
    first[:, 0] = adm_next
    slot_out = set_drop(slot_out, idx, first)
    return slot_active, slot_queue, slot_done, slot_last, slot_cap, slot_out


def _set_slots(g, slot_tgt, a):
    """``g[:, slot_tgt] = a`` for an L-stacked (L, N, ...) tensor, writes
    at ``slot_tgt == N`` dropped."""
    pad = torch.cat([g, g.new_zeros((g.shape[0], 1) + tuple(g.shape[2:]))],
                    dim=1)
    pad[:, slot_tgt.long()] = a
    return pad[:, :-1]


def _lm_step_dense(state: LMEngineState, cfg: LMEngineConfig, model_cfg, ctx,
                   params, prefill_fn, decode_fn):
    """Continuous-batching order: decode -> complete -> admit; a finished
    slot's replacement is admitted in the same step. Over data ranks
    ``decode_fn`` takes and returns this rank's rows (``model.
    batch_rows``) and ``prefill_fn`` the whole padded admission batch."""
    from repro_torch.models.model import DecodeState, batch_rows

    nslots = cfg.slots
    rows = batch_rows(nslots, ctx)
    active = state.slot_active
    eligible = active & ~_lm_terminal(cfg, state.slot_done, state.slot_cap,
                                      state.slot_last)
    dec = state.decode
    dec2, logits = decode_fn(params, state.slot_last[rows], dec)
    nxt = _greedy(logits, rows, nslots, ctx)
    slot_out, slot_done, slot_last = _record(state, cfg, eligible, nxt)
    # slots that did not decode keep their state
    mine = eligible[rows]
    dec_post = DecodeState(
        {k: torch.where(mine.reshape((1, -1) + (1,) * (v.dim() - 2)),
                        v, dec.layers[k])
         for k, v in dec2.layers.items()},
        torch.where(mine, dec2.pos, dec.pos),
    )

    finished = active & _lm_terminal(cfg, slot_done, state.slot_cap,
                                     slot_last)
    resp, slot_active, slot_queue, slot_done, slot_cap, completed = \
        _complete(state, cfg, finished, slot_done, slot_out)

    n_free = torch.sum((~slot_active).to(I32))
    budget = torch.clamp(n_free, max=cfg.admit_per_step)
    req, cpo, sch, prompts, caps, srcq, valid, slot_ids = _admission(
        state, cfg, slot_active, budget)
    admit_ok = valid & (torch.arange(cfg.admit_per_step,
                                     device=valid.device) < n_free)
    slot_tgt = torch.where(admit_ok, slot_ids, nslots)

    # the padded admission batch is prefilled as JAX prefills it (an MoE
    # block's capacity counts its tokens), but only when a prompt is
    # admitted (one host read per step): with none, every row it would
    # write is dropped
    new_layers, new_pos = dec_post.layers, dec_post.pos
    adm_next = torch.zeros_like(slot_ids)
    if bool(admit_ok.any()):
        adm_state, adm_logits = prefill_fn(params, prompts.to(I32))
        adm_next = _argmax(adm_logits)
        tgt = _local_slots(slot_tgt, rows)
        new_layers = {k: _set_slots(v, tgt, adm_state.layers[k])
                      for k, v in dec_post.layers.items()}
        new_pos = set_drop(dec_post.pos, (tgt.long(),), adm_state.pos)
    slot_active, slot_queue, slot_done, slot_last, slot_cap, slot_out = _seat(
        cfg, slot_tgt, admit_ok, srcq, caps, adm_next, slot_active,
        slot_queue, slot_done, slot_last, slot_cap, slot_out)
    return LMEngineState(
        req=req, resp=resp, cpoll=cpo, sched=sch,
        decode=DecodeState(new_layers, new_pos),
        slot_active=slot_active, slot_queue=slot_queue, slot_done=slot_done,
        slot_out=slot_out, slot_last=slot_last, slot_cap=slot_cap,
        slot_stalled=state.slot_stalled, steps=state.steps + 1,
        completed=completed,
    )


def _lm_step_paged(state: LMEngineState, cfg: LMEngineConfig, model_cfg, ctx,
                   params, prefill_fn=None):
    """The paged engine step, decode -> complete -> admit: decode attends
    read-only through the paged stats walk and appends every eligible
    slot's kv with one batched write; completion releases pages; admission
    is back-pressured by page credit and lands prompt kv straight into
    pages. Slots whose page allocation found the pool dry are flagged in
    ``slot_stalled`` for the swap service (:func:`make_swap_service`). The
    page pool is updated in place. Over data ranks every rank takes every
    slot's allocation, decodes its rows and writes its slots' pages
    (``model.paged_decode_step``)."""
    from repro_torch.models.model import (
        batch_rows, paged_decode_step, prefill_kv, whole_batch,
    )
    from repro_torch.serving import kv_cache as pk

    nslots = cfg.slots
    rows = batch_rows(nslots, ctx)
    pcfg = lm_paged_kv_config(cfg, model_cfg, ctx)
    kv = state.decode
    mppr = pcfg.max_pages_per_seq

    active = state.slot_active
    hot = kv.residency == pk.HOT
    eligible = active & hot & ~_lm_terminal(
        cfg, state.slot_done, state.slot_cap, state.slot_last)
    kv, logits, ok = paged_decode_step(
        params, state.slot_last, kv, pcfg, model_cfg, ctx, active=eligible,
        kernel_backend=cfg.kernel_backend)
    nxt = _greedy(logits, rows, nslots, ctx)
    advance = eligible & ok  # ok False = pool dry: the slot stalls
    stalled = eligible & ~ok
    slot_out, slot_done, slot_last = _record(state, cfg, advance, nxt)

    # cold slots never finish here: the swap service restores them first
    finished = active & hot & _lm_terminal(cfg, slot_done, state.slot_cap,
                                           slot_last)
    resp, slot_active, slot_queue, slot_done, slot_cap, completed = \
        _complete(state, cfg, finished, slot_done, slot_out)
    kv = pk.release_batch(kv, pcfg, finished)
    stalled = stalled & ~finished

    n_free = torch.sum((~slot_active).to(I32))
    n_active = nslots - n_free
    if cfg.host_pages:
        # oversubscribed: credit is expected-live pages against the total
        # hot + cold budget, and never more prompts than the device pool
        # can prefill now
        epp = lm_expected_pages_per_request(cfg)
        total = pcfg.num_pages + cfg.host_pages
        credit = torch.clamp(total - n_active * epp, min=0) // epp
        prompt_pages = max(-(-cfg.prompt_len // cfg.page_size), 1)
        credit = torch.minimum(credit, kv.free_top // prompt_pages)
    else:
        # every admitted request may grow to mppr pages: admit only what
        # the pool can commit to, so a decode allocation never fails
        credit = torch.clamp(pcfg.num_pages - n_active * mppr, min=0) // mppr
    budget = torch.clamp(torch.minimum(n_free, credit),
                         max=cfg.admit_per_step)
    req, cpo, sch, prompts, caps, srcq, valid, slot_ids = _admission(
        state, cfg, slot_active, budget)
    admit_ok = valid & (torch.arange(cfg.admit_per_step,
                                     device=valid.device) < n_free)

    # admit_ok is a prefix of the batch: prefill only those prompts (one
    # host read per step). JAX prefills the whole padded batch, because
    # its step is one jitted program of static shapes; the admitted rows
    # are the same either way. An MoE block's capacity depends on the
    # token count, so it is sized from the padded batch's: the prefix
    # comes first in token order and the dispatch sort is stable, so every
    # admitted assignment keeps JAX's slot and keep. The EP shard_map
    # dispatch is not prefix-exact (it splits the tokens into one block a
    # model rank and sizes each send buffer from its block), so under it
    # the whole padded batch is prefilled, as JAX does. Over data ranks
    # every rank prefills them all (``whole_batch``; the EP dispatch in
    # JAX's data blocks, :func:`admission_blocks`) and writes the pages of
    # its slots.
    n_adm = int(admit_ok.sum())
    adm_next = torch.zeros_like(slot_ids)
    if n_adm:
        whole = model_cfg.is_moe and ctx.ep_shardmap and ctx.mesh is not None
        batch = prompts.to(I32) if whole else prompts[:n_adm].to(I32)
        if prefill_fn is None:
            parts = [prefill_kv(
                params, batch[b], model_cfg, whole_batch(ctx),
                kernel_backend=cfg.kernel_backend,
                capacity_tokens=cfg.admit_per_step * cfg.prompt_len)
                for b in admission_blocks(batch.shape[0], model_cfg, ctx)]
            adm_k = torch.cat([p[0] for p in parts], 1)[:, :n_adm]
            adm_v = torch.cat([p[1] for p in parts], 1)[:, :n_adm]
            adm_logits = torch.cat([p[2] for p in parts])[:n_adm]
            del parts
        else:
            adm_k, adm_v, adm_logits = prefill_fn(params,
                                                  prompts[:n_adm].to(I32))
        adm_next[:n_adm] = _argmax(adm_logits)
        own = (slot_ids[:n_adm] >= rows.start) & (slot_ids[:n_adm]
                                                  < rows.stop)
        # the returned mask folds in the pool's all-or-nothing check
        kv, landed = pk.prefill_into_pages(
            kv, pcfg, slot_ids[:n_adm], adm_k, adm_v, admit_ok[:n_adm],
            own=own)
        admit_ok = torch.cat([landed, admit_ok[n_adm:]])
    slot_tgt = torch.where(admit_ok, slot_ids, nslots)
    slot_active, slot_queue, slot_done, slot_last, slot_cap, slot_out = _seat(
        cfg, slot_tgt, admit_ok, srcq, caps, adm_next, slot_active,
        slot_queue, slot_done, slot_last, slot_cap, slot_out)
    stalled = set_drop(stalled, (slot_tgt.long(),), False)
    return LMEngineState(
        req=req, resp=resp, cpoll=cpo, sched=sch, decode=kv,
        slot_active=slot_active, slot_queue=slot_queue, slot_done=slot_done,
        slot_out=slot_out, slot_last=slot_last, slot_cap=slot_cap,
        slot_stalled=stalled, steps=state.steps + 1, completed=completed,
    )


# ---------------------------------------------------------------------------
# Host-boundary swap service: device pool <-> host cold tier
# ---------------------------------------------------------------------------

def make_swap_service(cfg: LMEngineConfig, model_cfg, ctx, *, budget=None,
                      cold=None):
    """The step-boundary evict/restore policy of an oversubscribed paged
    engine (``cfg.host_pages > 0``). Returns ``(service, cold, pcfg)``:
    ``service(state) -> state`` runs between engine steps, reads a few
    (N,) vectors back to the host, and moves whole page sets with
    :func:`kv_cache.swap_out` / :func:`kv_cache.swap_in` and explicit
    device <-> host copies into the :class:`kv_cache.HostColdTier`.

    Policy (progress is guaranteed with the config-time
    ``host_pages >= (slots - 1) * mppr`` check): restore cold slots FIFO
    while the pool has a full worst-case request spare; evict at most one
    victim per call, only when stalled runners outnumber free pages — the
    youngest hot non-terminal slot, never the only runner.

    ``budget`` (a ``placement.MemoryBudget``) charges parked pages to the
    ledger the durability tier also reads, so eviction also needs budget
    headroom. Pass ``cold`` to reuse a tier (crash recovery restores into
    it).

    Under a mesh every rank runs the service on its replica of the
    engine's integers and takes the same decisions. Its tier holds its
    block of what it parks: its kv heads (its pool's), and over data
    ranks its slots' pages only (``HostColdTier(slots=)``; the host
    allocator runs for every slot). The budget charges the bytes the
    rank parks, so with a budget an eviction waits until every rank has
    the headroom (one sum over the mesh)."""
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.model import batch_rows
    from repro_torch.serving import kv_cache as pk

    if cfg.host_pages <= 0:
        raise ValueError("make_swap_service needs cfg.host_pages > 0")
    pcfg = lm_paged_kv_config(cfg, model_cfg, ctx)
    rows = batch_rows(cfg.slots, ctx)
    if cold is None:
        mine = None if rows == slice(0, cfg.slots) \
            else range(rows.start, rows.stop)
        cold = pk.HostColdTier(pcfg, cfg.host_pages,
                               dtype=dtype_of(model_cfg.dtype), budget=budget,
                               slots=mine)
    mppr = pcfg.max_pages_per_seq
    ps = pcfg.page_size

    def service(state: LMEngineState) -> LMEngineState:
        kvs = state.decode
        dev = kvs.lengths.device
        active = state.slot_active.cpu().numpy()
        stalled = state.slot_stalled.cpu().numpy()
        done = state.slot_done.cpu().numpy()
        cap = state.slot_cap.cpu().numpy()
        last = state.slot_last.cpu().numpy()
        lengths = kvs.lengths.cpu().numpy()
        hot = kvs.residency.cpu().numpy() == pk.HOT
        free_top = int(kvs.free_top)
        term = done >= cap
        if cfg.eos_token >= 0:
            term = term | ((done > 0) & (last == cfg.eos_token))

        # restore, FIFO by eviction order
        for slot in list(cold.order):
            npg = -(-int(lengths[slot]) // ps)
            if free_top < max(npg, mppr):
                break
            k = v = None
            if cold.parks(slot):
                k, v = (t.to(dev) for t in cold.load(slot))
            kvs, ok = pk.swap_in(kvs, pcfg, slot, k, v)
            if not bool(ok):
                break
            cold.drop(slot, restored=True)
            free_top -= npg

        # evict one victim when runners are starving
        n_stalled = int(np.sum(stalled & active & hot))
        if n_stalled and free_top < n_stalled:
            cand = active & hot & ~term
            if int(np.sum(cand)) > 1:  # never park the only runner
                order = np.argsort(done, kind="stable")
                victim = next((int(s) for s in order if cand[s]), None)
                npg = 0 if victim is None else -(-int(lengths[victim]) // ps)
                if victim is not None and _every_rank(
                        cold.can_accept(victim, npg), cold, ctx, dev):
                    kvs, k, v, ok = pk.swap_out(kvs, pcfg, victim)
                    if bool(ok):
                        cold.store(victim, k, v, npg)
        return state._replace(decode=kvs)

    return service, cold, pcfg


def _every_rank(ok: bool, cold, ctx, dev) -> bool:
    """``ok`` on every rank of ``ctx``'s mesh: the ranks' budgets differ
    (each charges what it parks), so a budgeted tier's acceptance is
    agreed by one sum; without a budget it is the same on every rank."""
    from repro_torch.parallel import collectives as coll

    if cold.budget is None or ctx.mesh is None or ctx.mesh.size == 1:
        return ok
    refused = torch.tensor([0 if ok else 1], dtype=I32, device=dev)
    return int(coll.psum(refused, ctx.mesh, tuple(ctx.mesh.axis_names))) == 0
