"""ORCA-KV (§IV-A): MICA-style set-associative in-memory hash KVS.

Layout follows the paper: a set-associative hash table whose entries hold
pointers into a slab-allocated value pool; hash collisions spill into one
overflow bucket, so a GET costs at most three memory accesses (primary
bucket, overflow bucket, value row) and a PUT four.

Everything is batched: a batch of requests is one vectorised walk, the
analogue of the APU's 256-outstanding-request memory-level parallelism.
The memory accesses go through ``kernels.ops``, which dispatches between
the CUDA kernels and their plain PyTorch versions by the ``backend`` knob
(``auto | cuda | ref``; the engine threads ``EngineConfig.kernel_backend``
through ``app_step``). PUT splits into :func:`plan_put` (hashes, dedupe,
way ranking — plain tensor work on both backends) and a commit that
either backend applies identically, so the paths agree bit for bit.

Hot-set cache tier: ``KVConfig.cache_sets > 0`` adds a small
set-associative cache — key/value/meta arrays in ``KVState`` under the
same sentinel convention — that GET probes before the bucket walk.
Eviction is frequency-decay (CLOCK-style reference bits in
``cache_meta``); PUT commits write through (update-on-hit, admit-on-miss)
so no stale value ever survives. All cache maintenance is plain tensor
work shared by the backends, like the PUT plan.

Mutation: a PUT commits into ``bucket_keys``, ``bucket_ptr`` and ``pool``
IN PLACE (the counterpart of the TPU kernels' ``input_output_aliases``;
the plain versions do the same), so the state passed to :func:`put` or
:func:`app_step` is updated. Every other field comes back as a new tensor.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import placement
from repro_torch.core import status as stc
from repro_torch.core._drop import add_drop, set_drop
from repro_torch.core.ringbuf import rank_within as _rank_within
from repro_torch.kernels import ops as kops

I32 = torch.int32
_M32 = 0xFFFFFFFF
_INT32_MAX = 2**31 - 1


class KVConfig(NamedTuple):
    num_buckets: int = 1024
    ways: int = 8
    key_words: int = 2
    val_words: int = 16  # 64 B values like the paper's workload
    pool_size: int = 8192
    cache_sets: int = 0  # hot-set cache sets; 0 disables the cache tier
    cache_ways: int = 4  # associativity of the hot-set cache


# Hot-set cache reference bits (CLOCK-style frequency decay).
# cache_meta values: 0 = never-used way; >= 1 = valid entry whose value is
# its remaining reference count. A probe hit refreshes to the ceiling, an
# admission starts one notch above the floor, and an admission attempt
# that finds no victim sweeps its set's counters down by one (floor 1, so
# a valid entry decays to "evictable" but never back to "empty"). Victims
# are ways with meta <= 1: empty first, then fully-decayed cold entries.
CACHE_REF_MAX = 15  # refresh: meta = 1 + CACHE_REF_MAX
CACHE_ADMIT_REF = 1  # admission: meta = 1 + CACHE_ADMIT_REF
CACHE_SALT = 0x85EBCA6B  # set hash salt (distinct from both bucket salts)
OVERFLOW_SALT = 0x9E3779B9  # salt of the overflow bucket's hash


class KVState(NamedTuple):
    """Sentinel-resident layout: every scatter-target array carries one
    permanent all-zero pad row past its live extent; dropped/no-op writes
    land there as zeros. Every field is durable truth (no write-ahead log);
    :data:`DURABLE_ROW_ARRAYS` are the row-indexed ones."""

    bucket_keys: torch.Tensor  # (NB + 1, W, KW) int32; row NB = zero sentinel
    bucket_ptr: torch.Tensor  # (NB + 1, W) int32 value-pool row, -1 = empty
    pool: torch.Tensor  # (NP + 1, VW) int32; row NP = zero sentinel
    alloc: torch.Tensor  # () int32 bump allocator
    dropped: torch.Tensor  # () int32 PUTs rejected (both buckets full)
    cache_keys: torch.Tensor  # (CS + 1, CW, KW) int32 cached keys
    cache_vals: torch.Tensor  # (CS + 1, CW, VW) int32 cached values
    cache_meta: torch.Tensor  # (CS + 1, CW) int32 CLOCK bits; 0 = empty way
    cache_hits: torch.Tensor  # () int32 GETs served from the cache tier
    cache_misses: torch.Tensor  # () int32 GETs that fell through to the walk
    cache_evictions: torch.Tensor  # () int32 valid-but-decayed entries replaced

    @property
    def num_buckets(self) -> int:
        """Live bucket rows (the resident sentinel row excluded)."""
        return self.bucket_keys.shape[0] - 1

    @property
    def pool_size(self) -> int:
        """Live value-pool rows (the resident sentinel row excluded)."""
        return self.pool.shape[0] - 1

    @property
    def cache_sets(self) -> int:
        """Live cache set rows (0 = cache tier disabled)."""
        return self.cache_keys.shape[0] - 1

    @property
    def cache_ways(self) -> int:
        return self.cache_keys.shape[1]


# KVState fields that are large row-indexed arrays (axis 0 = row); every
# other field is a scalar counter.
DURABLE_ROW_ARRAYS = (
    "bucket_keys", "bucket_ptr", "pool", "cache_keys", "cache_vals",
    "cache_meta",
)


def make(cfg: KVConfig, device="cuda") -> KVState:
    """An empty store on ``device``. The sentinel row of bucket_ptr is 0
    (not -1), so every sentinel row in the state is all-zero."""
    if cfg.cache_sets:
        cache_bytes = placement.kvs_cache_bytes(
            cfg.cache_sets, cfg.cache_ways, cfg.key_words, cfg.val_words
        )
        if cache_bytes > placement.CACHE_BUDGET:
            raise ValueError(
                f"hot-set cache ({cache_bytes} B) exceeds the L2 budget "
                f"({placement.CACHE_BUDGET} B) — shrink cache_sets/cache_ways"
            )
    z = lambda *shape: torch.zeros(shape, dtype=I32, device=device)  # noqa: E731
    bucket_ptr = torch.full((cfg.num_buckets + 1, cfg.ways), -1, dtype=I32,
                            device=device)
    bucket_ptr[cfg.num_buckets] = 0
    return KVState(
        bucket_keys=z(cfg.num_buckets + 1, cfg.ways, cfg.key_words),
        bucket_ptr=bucket_ptr,
        pool=z(cfg.pool_size + 1, cfg.val_words),
        alloc=z(),
        dropped=z(),
        cache_keys=z(cfg.cache_sets + 1, cfg.cache_ways, cfg.key_words),
        cache_vals=z(cfg.cache_sets + 1, cfg.cache_ways, cfg.val_words),
        cache_meta=z(cfg.cache_sets + 1, cfg.cache_ways),
        cache_hits=z(),
        cache_misses=z(),
        cache_evictions=z(),
    )


def hash_keys(keys, num_buckets: int, salt: int = 0):
    """FNV-1a over key words -> bucket id. keys: (..., KW) int32.

    The hash is 32-bit unsigned arithmetic, computed in int64 with a mask
    after every step (torch has no uint32 remainder on the CPU); a
    negative key word enters as its two's-complement uint32 value.
    ``num_buckets`` need not be a power of two."""
    h = torch.full(keys.shape[:-1], (2166136261 ^ salt) & _M32,
                   dtype=torch.int64, device=keys.device)
    for w in range(keys.shape[-1]):
        h = h ^ (keys[..., w].to(torch.int64) & _M32)
        h = (h * 16777619) & _M32
    return (h % num_buckets).to(I32)


def _bucket_hashes(keys, nb: int):
    return hash_keys(keys, nb), hash_keys(keys, nb, salt=OVERFLOW_SALT)


def get(state: KVState, keys, mask=None, *, backend: Optional[str] = "auto",
        with_state: bool = False):
    """Batched GET. keys: (B, KW). Returns (vals (B, VW), found (B,)) —
    or (state, vals, found) under ``with_state=True``, where the returned
    state carries the hot-set cache maintenance (reference-bit refresh on
    hits, admission of found misses, hit/miss counters). Bucket arrays and
    the pool are never modified by a GET.

    With the cache tier enabled the walk is: one ``cache_probe`` first,
    then the bucket walk for the miss subset — hit rows retarget the
    resident sentinel bucket. The JAX package skips the walk when every
    live row hit; here the walk always runs (no host sync to decide) and
    its values are masked to what the skip returns."""
    nb = state.num_buckets
    if state.cache_sets == 0:
        h1, h2 = _bucket_hashes(keys, nb)
        vals, found = kops.hash_get(
            state.bucket_keys, state.bucket_ptr, state.pool, keys, h1, h2,
            backend=backend,
        )
        if mask is not None:
            found = found & mask
        return (state, vals, found) if with_state else (vals, found)

    live = torch.ones(keys.shape[:1], dtype=torch.bool, device=keys.device) \
        if mask is None else mask
    cset = hash_keys(keys, state.cache_sets, salt=CACHE_SALT)
    hit, way, cvals = kops.cache_probe(
        state.cache_keys, state.cache_vals, state.cache_meta, keys, cset,
        backend=backend,
    )
    h1, h2 = _bucket_hashes(keys, nb)
    bvals, bfound = kops.hash_get(
        state.bucket_keys, state.bucket_ptr, state.pool, keys,
        torch.where(hit, nb, h1).to(I32), torch.where(hit, nb, h2).to(I32),
        backend=backend,
    )
    # where JAX skips the walk (every live row hit), its values are zero;
    # the walk's found flags need no mask: with every live row a hit they
    # reach neither the admissions nor the live rows' found
    bvals = torch.where(torch.all(hit | ~live), 0, bvals)
    found_raw = hit | bfound
    vals = torch.where(
        found_raw[:, None], torch.where(hit[:, None], cvals, bvals), 0
    )
    found = found_raw & live
    if not with_state:
        return vals, found if mask is not None else found_raw

    # maintenance: refresh reference bits on live hits; admit live misses
    # the bucket walk found (deduped — a batch can GET one key twice)
    refresh = live & hit
    admit = _first_live(keys, live & ~hit & bfound)
    ck, cv, cm, n_evict = _cache_commit(
        state, keys, cset, refresh, way, admit, bvals
    )
    state = state._replace(
        cache_keys=ck, cache_vals=cv, cache_meta=cm,
        cache_hits=state.cache_hits + torch.sum(refresh.to(I32)).to(I32),
        cache_misses=state.cache_misses
        + torch.sum((live & ~hit).to(I32)).to(I32),
        cache_evictions=state.cache_evictions + n_evict,
    )
    return state, vals, found


def _lexsort(keys, lead):
    """The order ``jnp.lexsort`` gives for ``(keys[:, KW-1], ...,
    keys[:, 0], lead)``: ``lead`` is the primary key, then the key words
    in order; ties keep their input order. Chained stable sorts, least
    significant key first."""
    order = torch.arange(keys.shape[0], device=keys.device)
    cols = [keys[:, w] for w in reversed(range(keys.shape[1]))] + [lead]
    for col in cols:
        order = order[torch.argsort(col[order], stable=True)]
    return order


def _nth_empty_way(bp_rows, rank):
    """bp_rows: (B, W) pointers; rank: (B,). Index of the rank-th empty way
    (W if fewer empties than rank+1)."""
    empty = bp_rows < 0  # (B, W)
    csum = torch.cumsum(empty.to(I32), dim=-1)
    is_nth = empty & (csum == rank[:, None] + 1)
    has = torch.any(is_nth, dim=-1)
    way = torch.argmax(is_nth.to(I32), dim=-1)  # first maximum, as in JAX
    return torch.where(has, way, bp_rows.shape[-1]).to(I32)


def _first_live(keys, rows):
    """Keep only the first instance of each key among ``rows`` (the cache
    admission dedupe, so duplicate GETs of one key admit once)."""
    b = keys.shape[0]
    order = _lexsort(keys, (~rows).to(I32))
    sk = keys[order]
    sr = rows[order]
    boundary = torch.any(sk[1:] != sk[:-1], dim=-1) | (sr[1:] != sr[:-1])
    first_sorted = torch.cat([boundary.new_ones((1,)), boundary])
    is_first = torch.zeros((b,), dtype=torch.bool, device=keys.device)
    is_first[order] = first_sorted
    return rows & is_first


def _cache_commit(state, keys, cset, refresh, way, admit, admit_vals,
                  upd_vals=None):
    """One batch of hot-set cache maintenance — plain tensor work shared by
    both backends (like ``plan_put``).

    ``refresh`` rows bump (cset, way) to the reference ceiling and — when
    ``upd_vals`` is given (the PUT write-through) — overwrite the cached
    value. ``admit`` rows must carry unique keys (callers dedupe); each
    takes the rank-th victim way of its set (meta <= 1 after the CLOCK
    decay: empty first, then fully-decayed entries), so live scatter
    targets never collide. No-op rows aim one past the sentinel row and
    are discarded — the sentinel row itself stays zero.

    Returns new (cache_keys, cache_vals, cache_meta, n_evictions)."""
    cs = state.cache_sets
    cw = state.cache_ways
    dev = keys.device
    meta = state.cache_meta

    # CLOCK hand: an admission attempt sweeps its set's counters down one
    # notch (floor 1), but ONLY when the set has no victim way left (every
    # way live with meta > 1) — scan resistance, as in the JAX package
    att = add_drop(
        torch.zeros((cs + 1,), dtype=I32, device=dev),
        (torch.where(admit, cset, cs + 1),), 1,
    ) > 0
    pressured = att & ~torch.any(meta <= 1, dim=1)
    meta = torch.where(pressured[:, None] & (meta > 0),
                       torch.clamp(meta - 1, min=1), meta)

    rset = torch.where(refresh, cset, cs + 1)
    rway = torch.where(refresh, torch.clamp(way, 0, cw - 1), 0)
    meta = set_drop(meta, (rset, rway), 1 + CACHE_REF_MAX)
    cache_vals = state.cache_vals
    if upd_vals is not None:
        cache_vals = set_drop(cache_vals, (rset, rway), upd_vals)

    # ranked admission: the r-th admitting key of a set takes the r-th
    # victim way; sets with more admissions than victims drop the excess
    r = _rank_within(torch.where(admit, cset, cs), cs + 1)
    victim_ok = torch.where(meta <= 1, -1, 0)  # _nth_empty_way convention
    vict = _nth_empty_way(victim_ok[cset], r)
    can = admit & (vict < cw)
    vclip = torch.clamp(vict, 0, cw - 1)
    n_evict = torch.sum((can & (meta[cset, vclip] == 1)).to(I32)).to(I32)
    aset = torch.where(can, cset, cs + 1)
    away = torch.where(can, vclip, 0)
    cache_keys = set_drop(state.cache_keys, (aset, away), keys)
    cache_vals = set_drop(cache_vals, (aset, away), admit_vals)
    meta = set_drop(meta, (aset, away), 1 + CACHE_ADMIT_REF)
    return cache_keys, cache_vals, meta, n_evict


class PutPlan(NamedTuple):
    """The ALU half of a batched PUT: where every write lands.

    ``tb == NB`` means no bucket write, ``wp == NP`` means no value write —
    both backends aim them at the state's resident zero sentinel row and
    zero the payload. The JAX plan also carries the target sort orders,
    which only its in-order TPU commit needs; neither commit here does."""

    tb: torch.Tensor  # (B,) target bucket row
    tw: torch.Tensor  # (B,) target way within the bucket
    bptr_val: torch.Tensor  # (B,) pool pointer committed at (tb, tw)
    wp: torch.Tensor  # (B,) pool row receiving the value
    alloc: torch.Tensor  # () updated bump allocator
    dropped: torch.Tensor  # () updated drop counter
    ok: torch.Tensor  # (B,) per-request success


def plan_put(state: KVState, keys, mask=None, *,
             backend: Optional[str] = "auto") -> PutPlan:
    """Plan a batched PUT/UPDATE (dedupe, match, way ranking) without
    touching the store. The existence check — the PUT's first two memory
    accesses — dispatches to the probe kernel by ``backend``.

    Two parts are O(state) per call, as in the JAX package: the per-bucket
    ranks search over all NB + 1 bucket ids, and the phase-1 occupancy is
    a full copy of ``bucket_ptr``."""
    b = keys.shape[0]
    dev = keys.device
    if mask is None:
        mask = torch.ones((b,), dtype=torch.bool, device=dev)
    nb = state.num_buckets
    np_ = state.pool_size
    ways = state.bucket_ptr.shape[1]
    h1, h2 = _bucket_hashes(keys, nb)

    # dedupe identical keys in the batch: only the first LIVE instance
    # inserts, and only the last LIVE instance writes the value row
    # (last-writer-wins). Masked rows sort behind the live section and runs
    # split at the live/masked boundary, so a masked row sharing a key with
    # a live PUT can steal neither the run's insert nor its value write
    order = _lexsort(keys, (~mask).to(I32))
    sorted_keys = keys[order]
    live_sorted = mask[order]
    run_boundary = torch.any(sorted_keys[1:] != sorted_keys[:-1], dim=-1) | (
        live_sorted[1:] != live_sorted[:-1]
    )
    is_first_sorted = torch.cat([run_boundary.new_ones((1,)), run_boundary])
    is_first = torch.zeros((b,), dtype=torch.bool, device=dev)
    is_first[order] = is_first_sorted

    # existence check (memory accesses 1+2): probe kernel or plain version
    # — both return ptr only where found, which is the only place it is read
    exists, ptr_existing = kops.hash_probe(
        state.bucket_keys, state.bucket_ptr, keys, h1, h2, backend=backend,
    )

    # --- inserts: two-phase so primary and spill writers never collide ---
    # phase 1: primary-bucket inserters rank among themselves per bucket
    inserting = mask & is_first & ~exists
    r1 = _rank_within(torch.where(inserting, h1, nb), nb + 1)
    w1 = _nth_empty_way(state.bucket_ptr[h1], r1)
    fits1 = inserting & (w1 < ways)
    spill = inserting & ~fits1

    # phase-1 occupancy, so phase 2 sees primaries as occupied (a batch can
    # feed one bucket through BOTH h1 and h2). A copy, never a write into
    # the state. Non-fitting rows aim at the copy's sentinel row NB, which
    # phase 2 never reads (h2 < NB), where JAX aims them past the array.
    occ_ptr = state.bucket_ptr.clone()
    occ_ptr[torch.where(fits1, h1, nb), torch.where(fits1, w1, 0)] = _INT32_MAX

    # phase 2: spill inserters rank against the UPDATED occupancy
    r2 = _rank_within(torch.where(spill, h2, nb), nb + 1)
    w2 = _nth_empty_way(occ_ptr[h2], r2)
    fits2 = spill & (w2 < ways)
    drop = spill & ~fits2

    fits_struct = fits1 | fits2
    new_rank = torch.cumsum(fits_struct.to(I32), dim=0).to(I32) - 1
    new_ptr = state.alloc + new_rank
    pool_ok = new_ptr < np_
    fits1 = fits1 & pool_ok
    fits2 = fits2 & pool_ok
    drop = drop | (fits_struct & ~pool_ok)
    fits = fits1 | fits2

    tb = torch.where(fits1, h1, torch.where(fits2, h2, nb)).to(I32)
    tw = torch.where(fits1, w1, torch.where(fits2, w2, 0)).to(I32)
    bptr_val = torch.where(fits, new_ptr, -1).to(I32)

    # --- value writes: updates + inserts, last-writer-wins ---------------
    # among duplicate keys only the LAST batch instance writes its value,
    # to the pool row the FIRST instance resolved (hit or fresh insert)
    first_ptr = torch.where(
        exists, ptr_existing, torch.where(fits, new_ptr, -1)
    ).to(I32)
    run_id_sorted = torch.cumsum(is_first_sorted.to(I32), dim=0) - 1
    run_ptr = torch.full((b,), -1, dtype=I32, device=dev).scatter_reduce(
        0, run_id_sorted,
        torch.where(is_first_sorted, first_ptr[order], -1).to(I32),
        reduce="amax", include_self=True,
    )
    eff_ptr = torch.zeros((b,), dtype=I32, device=dev)
    eff_ptr[order] = run_ptr[run_id_sorted]
    last_in_sorted = torch.cat([run_boundary, run_boundary.new_ones((1,))])
    is_last = torch.zeros((b,), dtype=torch.bool, device=dev)
    is_last[order] = last_in_sorted
    row_live = mask & is_last & (eff_ptr >= 0)
    wp = torch.where(row_live, eff_ptr, np_).to(I32)

    alloc = state.alloc + torch.clamp(torch.sum(fits.to(I32)), min=0).to(I32)
    dropped = state.dropped + torch.sum(drop.to(I32)).to(I32)
    ok = mask & (exists | fits)
    return PutPlan(tb, tw, bptr_val, wp, alloc, dropped, ok)


def put(state: KVState, keys, vals, mask=None, *,
        backend: Optional[str] = "auto"):
    """Batched PUT/UPDATE. keys: (B, KW), vals: (B, VW), both contiguous.
    Returns (state, ok). Commits ``bucket_keys``/``bucket_ptr``/``pool``
    IN PLACE; the returned state holds those same tensors.

    In-batch duplicate keys resolve last-writer-wins on the value row;
    insertion conflicts are resolved exactly via per-bucket ranking (each
    new key takes the rank-th empty way). Keys that fit in neither bucket
    are dropped and counted. With the cache tier enabled the commit is
    write-through: the final writer of every landed key updates any cached
    copy, and misses are admission attempts gated by the reference bits.
    """
    plan = plan_put(state, keys, mask, backend=backend)
    bucket_keys, bucket_ptr, pool = kops.hash_put(
        state.bucket_keys, state.bucket_ptr, state.pool, keys, vals,
        plan.tb, plan.tw, plan.bptr_val, plan.wp, backend=backend,
    )
    state = state._replace(
        bucket_keys=bucket_keys, bucket_ptr=bucket_ptr, pool=pool,
        alloc=plan.alloc, dropped=plan.dropped,
    )
    if state.cache_sets > 0:
        state = _put_write_through(state, keys, vals, plan, backend)
    return state, plan.ok


def _put_write_through(state: KVState, keys, vals, plan: PutPlan,
                       backend) -> KVState:
    """Cache side of a committed PUT: the rows that wrote their run's final
    value (``plan.wp`` targets a live pool row — unique keys by
    construction) update-on-hit / admit-on-miss, so the cached copy always
    equals the pool row just written."""
    rows = plan.wp < state.pool_size
    cset = hash_keys(keys, state.cache_sets, salt=CACHE_SALT)
    hit, way, _ = kops.cache_probe(
        state.cache_keys, state.cache_vals, state.cache_meta, keys, cset,
        backend=backend,
    )
    ck, cv, cm, n_evict = _cache_commit(
        state, keys, cset, rows & hit, way, rows & ~hit, vals, upd_vals=vals
    )
    return state._replace(
        cache_keys=ck, cache_vals=cv, cache_meta=cm,
        cache_evictions=state.cache_evictions + n_evict,
    )


# ---------------------------------------------------------------------------
# Request-level interface (engine app): HERD-style fixed-width RPC slots.
# word0 = op (0 nop / 1 GET / 2 PUT), words[1:1+KW] = key, rest = value.
# Response: word0 = status (1 found/ok), rest = value.
# ---------------------------------------------------------------------------

OP_NOP, OP_GET, OP_PUT = 0, 1, 2


def request_words(cfg: KVConfig) -> int:
    return 1 + cfg.key_words + cfg.val_words


def app_step(state: KVState, payloads, valid, cfg: KVConfig, *,
             kernel_backend: Optional[str] = "auto"):
    """Engine hook: payloads (B, 1+KW+VW) int32 -> (state, responses).

    ``kernel_backend`` is the engine's dispatch knob. An unknown opcode
    NACKs as MALFORMED and its row is masked out of both walks. GETs read
    the store from before this batch's PUTs."""
    op = payloads[:, 0]
    keys = payloads[:, 1: 1 + cfg.key_words].contiguous()
    vals = payloads[
        :, 1 + cfg.key_words: 1 + cfg.key_words + cfg.val_words
    ].contiguous()
    bad = valid & ~((op == OP_NOP) | (op == OP_GET) | (op == OP_PUT))
    state, get_vals, found = get(
        state, keys, mask=valid & (op == OP_GET), backend=kernel_backend,
        with_state=True,
    )
    state, put_ok = put(
        state, keys, vals, mask=valid & ~bad & (op == OP_PUT),
        backend=kernel_backend,
    )
    status = torch.where(
        op == OP_GET, found.to(I32),
        torch.where(op == OP_PUT, put_ok.to(I32), 0),
    )
    status = torch.where(bad, stc.MALFORMED, status).to(I32)
    resp = torch.cat(
        [status[:, None], torch.where((op == OP_GET)[:, None], get_vals, 0)],
        dim=1,
    )
    pad = payloads.shape[1] - resp.shape[1]
    if pad > 0:
        resp = F.pad(resp, (0, pad))
    return state, resp
