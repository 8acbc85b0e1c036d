"""Paged KV cache pool: the serving layer's data-structure walker.

The KVS walks hash buckets to value rows; LM serving walks a page table to
KV pages. Pages live in one pool per layer; sequences own pages through a
table; a stack allocator hands pages out and takes them back. Attention
over the pool is ``paged_attention_stats`` (``csrc/paged_attention.cu``,
or its plain version) through the ``auto | cuda | ref`` knob. Decode never
writes pages inside the layer loop: it attends read-only and commits every
layer's new kv with one :func:`append_token_batch` per step.

The pool carries one extra zero **sentinel page** at physical index
``num_pages``: unmapped table entries (-1) resolve there during the walk,
so a dead entry reads zeros, never another sequence's live page. Writes
that must vanish (the JAX package's ``mode="drop"`` scatters past the
pool) are aimed at the sentinel with zero values, which leaves it zero and
costs no copy of the pool.

**Residency**: each sequence's pages are HOT (mapped in the device pool)
or COLD (its table row unmapped, its data parked in a
:class:`HostColdTier`); a COLD slot keeps its ``lengths`` entry. Moves
between the tiers happen at the engine-step boundary (:func:`swap_out`,
:func:`swap_in`).

Updates write the pool tensors IN PLACE and return the state (the JAX
package donates the pool instead): clone a state first where the old one
is still needed.

**Over data ranks** (the LM engine's slots split over them) every rank
holds the whole allocator, page table, lengths and residency and takes
every slot's allocation in the same order, so all ranks hold the same
integers; the page data a rank writes are its own slots' only
(``rows`` of :func:`append_token_batch`, ``own`` of
:func:`prefill_into_pages`, ``k=None`` in :func:`swap_in`), and its
:class:`HostColdTier` parks only its slots' pages. A page another rank's
slot holds is stale here, and no walk of this rank reads it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core._drop import set_drop

I32 = torch.int32

#: residency states: HOT = pages mapped in the device pool; COLD = pages
#: parked in the host tier, table row unmapped.
HOT = 0
COLD = 1


class PagedKVConfig(NamedTuple):
    num_pages: int = 64  # pool pages per layer, excluding the sentinel
    page_size: int = 16
    max_pages_per_seq: int = 8
    kv_heads: int = 2
    head_dim: int = 16
    layers: int = 2


class PagedKVState(NamedTuple):
    k_pages: torch.Tensor  # (L, NP + 1, PS, KVH, HD); page NP is the sentinel
    v_pages: torch.Tensor
    page_table: torch.Tensor  # (B, MaxP) int32, -1 = unmapped
    lengths: torch.Tensor  # (B,) tokens stored per sequence
    free_stack: torch.Tensor  # (NP,) page ids; [0:free_top) are free
    free_top: torch.Tensor  # () int32
    residency: torch.Tensor  # (B,) int32 HOT/COLD


def make(cfg: PagedKVConfig, batch: int, dtype=torch.bfloat16,
         device="cuda") -> PagedKVState:
    """Allocate the pool, with the zero sentinel page at index
    ``cfg.num_pages`` (never handed out by the allocator)."""
    shape = (cfg.layers, cfg.num_pages + 1, cfg.page_size, cfg.kv_heads,
             cfg.head_dim)
    return PagedKVState(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        page_table=torch.full((batch, cfg.max_pages_per_seq), -1, dtype=I32,
                              device=device),
        lengths=torch.zeros((batch,), dtype=I32, device=device),
        free_stack=torch.arange(cfg.num_pages, dtype=I32, device=device),
        free_top=torch.tensor(cfg.num_pages, dtype=I32, device=device),
        residency=torch.full((batch,), HOT, dtype=I32, device=device),
    )


def clone(state: PagedKVState) -> PagedKVState:
    """A deep copy (the updates below write the pool in place)."""
    return PagedKVState(*(t.clone() for t in state))


def pages_in_use(state: PagedKVState, cfg: PagedKVConfig) -> torch.Tensor:
    return cfg.num_pages - state.free_top


def kv_bytes_in_use(state: PagedKVState, cfg: PagedKVConfig) -> torch.Tensor:
    """Resident KV bytes, bounded by the tokens held, rounded to pages. An
    int64 count: a full-width pool passes 2^31 bytes."""
    per_page = (2 * cfg.layers * cfg.page_size * cfg.kv_heads * cfg.head_dim
                * state.k_pages.element_size())
    return pages_in_use(state, cfg).to(torch.int64) * per_page


def _cumrank(mask):
    """Rank of each True among the Trues before it (int32), -1 elsewhere
    up to the first True."""
    return torch.cumsum(mask.to(I32), 0, dtype=I32) - 1


def _count(mask):
    return torch.sum(mask.to(I32)).to(I32)


def _write_pages(pages, rows, offs, vals, live):
    """``pages[:, rows, offs] = vals`` where ``live``; other writes land as
    zeros on the sentinel page (the JAX package's dropped writes)."""
    sentinel = pages.shape[1] - 1
    rows = torch.where(live, rows, sentinel).long()
    shape = live.shape + (1,) * (vals.dim() - 1 - live.dim())
    vals = torch.where(live.reshape(shape), vals.to(pages.dtype), 0)
    if offs is None:
        pages[:, rows] = vals
    else:
        pages[:, rows, offs.long()] = vals


# ---------------------------------------------------------------------------
# Batched allocator ops
# ---------------------------------------------------------------------------

def ensure_capacity_batch(state: PagedKVState, cfg: PagedKVConfig, need):
    """Map a fresh page for every sequence in ``need`` (B,) bool whose next
    token crosses a page boundary; allocations pop distinct entries off
    the free-stack top in batch order. Returns (state, ok (B,)): ok False
    where the pool or the sequence's table is exhausted. COLD sequences
    never allocate."""
    ln = state.lengths
    need = need & (state.residency == HOT)
    page_idx = ln // cfg.page_size
    wants = need & (ln % cfg.page_size == 0)
    alloc_req = wants & (page_idx < cfg.max_pages_per_seq)
    rank = _cumrank(alloc_req)
    can = alloc_req & (rank < state.free_top)
    src = torch.clamp(state.free_top - 1 - rank, 0,
                      state.free_stack.shape[0] - 1)
    page = state.free_stack[src.long()]
    cols = torch.clamp(page_idx, 0, cfg.max_pages_per_seq - 1)
    hit = can[:, None] & (torch.arange(cfg.max_pages_per_seq, device=ln.device)
                          [None, :] == cols[:, None])
    table = torch.where(hit, page[:, None], state.page_table)
    free_top = state.free_top - _count(can)
    ok = (~wants) | can
    return state._replace(page_table=table, free_top=free_top), ok


def append_token_batch(state: PagedKVState, cfg: PagedKVConfig, k_new, v_new,
                       mask, rows: Optional[slice] = None):
    """Append one token's kv for every masked sequence at once, in place.

    k_new/v_new: (L, B, KVH, HD); mask: (B,) bool. Pages must already be
    mapped (:func:`ensure_capacity_batch`); unmapped targets are dropped
    and COLD sequences never append. With ``rows`` (a slice of the B
    sequences: a data rank's) k_new/v_new hold those rows only and only
    their pages are written; every masked sequence's length advances."""
    ln = state.lengths
    mask = mask & (state.residency == HOT)
    b = ln.shape[0]
    col = torch.clamp(ln // cfg.page_size, 0, cfg.max_pages_per_seq - 1)
    page = state.page_table[torch.arange(b, device=ln.device), col.long()]
    live = mask & (page >= 0)
    off = ln % cfg.page_size
    w = slice(0, b) if rows is None else rows
    _write_pages(state.k_pages, page[w], off[w], k_new, live[w])
    _write_pages(state.v_pages, page[w], off[w], v_new, live[w])
    return state._replace(lengths=ln + live.to(I32))


def _push_free(state: PagedKVState, pages, live):
    """Push ``pages[live]`` (flat) onto the free stack in order."""
    rank = _cumrank(live)
    pos = torch.where(live, state.free_top + rank, state.free_stack.shape[0])
    stack = set_drop(state.free_stack, (pos.long(),), pages)
    return stack, state.free_top + _count(live)


def release_batch(state: PagedKVState, cfg: PagedKVConfig, mask):
    """Return every masked sequence's pages to the pool in one batched
    push. Length-0 sequences are no-ops (no double free); a COLD slot
    frees no device pages but its length and residency reset — the caller
    drops its host stash too."""
    n_pages = (state.lengths + cfg.page_size - 1) // cfg.page_size
    cols = torch.arange(cfg.max_pages_per_seq, device=mask.device)
    live = mask[:, None] & (cols[None, :] < n_pages[:, None])
    live = live & (state.page_table >= 0)
    stack, free_top = _push_free(state, state.page_table.reshape(-1),
                                 live.reshape(-1))
    return state._replace(
        page_table=torch.where(mask[:, None], -1, state.page_table),
        lengths=torch.where(mask, 0, state.lengths),
        free_stack=stack, free_top=free_top,
        residency=torch.where(mask, HOT, state.residency),
    )


def prefill_into_pages(state: PagedKVState, cfg: PagedKVConfig, slot_ids,
                       k, v, mask, own=None):
    """Land prompt kv directly into pages for a batch of admitted slots.

    slot_ids: (A,) target sequences; k/v: (L, A, P, KVH, HD); mask: (A,)
    which admissions are real. Allocates ``ceil(P / page_size)`` pages per
    masked slot, all or nothing across the batch, writes the P tokens and
    sets the lengths. ``own`` (A,) bool, when given, limits the page
    writes to those admissions (a data rank's slots); the allocation is
    every masked admission's. Returns (state, ok (A,))."""
    a, p = k.shape[1], k.shape[2]
    ps = cfg.page_size
    npg = -(-p // ps)
    if npg > cfg.max_pages_per_seq:
        raise ValueError(
            f"prompt of {p} tokens needs {npg} pages > max_pages_per_seq"
            f" {cfg.max_pages_per_seq}"
        )
    dev = slot_ids.device
    b = state.lengths.shape[0]
    want = mask[:, None].expand(a, npg)
    enough = _count(want) <= state.free_top
    mask = mask & enough
    flat = (want & enough).reshape(-1)
    rank = _cumrank(flat)
    src = torch.clamp(state.free_top - 1 - rank, 0,
                      state.free_stack.shape[0] - 1)
    pages = state.free_stack[src.long()]  # (A*npg,)
    slot_rows = torch.where(flat, slot_ids.repeat_interleave(npg), b)
    cols = torch.arange(npg, device=dev).repeat(a)
    table = set_drop(state.page_table, (slot_rows.long(), cols), pages)
    free_top = state.free_top - _count(flat)

    # token t -> (page[t // ps], t % ps)
    tok = torch.arange(p, device=dev)
    tok_page = pages.reshape(a, npg)[:, tok // ps]  # (A, P)
    live = (mask if own is None else mask & own)[:, None].expand(a, p)
    off = (tok % ps).expand(a, p)
    _write_pages(state.k_pages, tok_page, off, k, live)
    _write_pages(state.v_pages, tok_page, off, v, live)
    tgt = (torch.where(mask, slot_ids, b).long(),)
    lengths = set_drop(state.lengths, tgt, p)
    residency = set_drop(state.residency, tgt, HOT)
    return state._replace(
        page_table=table, lengths=lengths, free_top=free_top,
        residency=residency,
    ), mask


# ---------------------------------------------------------------------------
# Per-sequence forms (delegate to the batched ops)
# ---------------------------------------------------------------------------

def _one_hot(state: PagedKVState, seq: int) -> torch.Tensor:
    mask = torch.zeros(state.lengths.shape, dtype=torch.bool,
                       device=state.lengths.device)
    mask[seq] = True
    return mask


def ensure_capacity(state: PagedKVState, cfg: PagedKVConfig, seq: int):
    """Map a fresh page for ``seq`` when its next token crosses a page
    boundary. Returns (state, ok): ok a 0-d bool tensor, False when the
    pool or the sequence's table is exhausted."""
    state, ok = ensure_capacity_batch(state, cfg, _one_hot(state, seq))
    return state, ok[seq]


def append_token(state: PagedKVState, cfg: PagedKVConfig, seq: int, k_new,
                 v_new) -> PagedKVState:
    """Append one token of ``seq``, in place. k_new/v_new: (L, KVH, HD),
    the token's kv for every layer."""
    b = state.lengths.shape[0]
    kb = k_new[:, None].expand(k_new.shape[0], b, *k_new.shape[1:])
    vb = v_new[:, None].expand(v_new.shape[0], b, *v_new.shape[1:])
    return append_token_batch(state, cfg, kb, vb, _one_hot(state, seq))


def release(state: PagedKVState, cfg: PagedKVConfig, seq: int
            ) -> PagedKVState:
    """Return a finished sequence's pages to the pool."""
    return release_batch(state, cfg, _one_hot(state, seq))


# ---------------------------------------------------------------------------
# Hot/cold tiering: evict a sequence's pages to the host, restore on resume
# ---------------------------------------------------------------------------

def swap_out(state: PagedKVState, cfg: PagedKVConfig, seq: int):
    """Evict ``seq``'s pages from the device pool (preemption): gather its
    pages into dense (L, MaxP, PS, KVH, HD) buffers (unmapped columns read
    the sentinel), push its pages back on the free stack, unmap its row
    and mark it COLD; ``lengths[seq]`` is kept. Returns
    ``(state, k, v, ok)``; ok False (state unchanged) when ``seq`` is not
    a HOT sequence with tokens."""
    rows = state.page_table[seq]
    src = torch.where(rows >= 0, rows, cfg.num_pages).long()
    k = state.k_pages[:, src]
    v = state.v_pages[:, src]
    ok = (state.residency[seq] == HOT) & (state.lengths[seq] > 0)
    npg = (state.lengths[seq] + cfg.page_size - 1) // cfg.page_size
    cols = torch.arange(cfg.max_pages_per_seq, device=rows.device)
    live = ok & (cols < npg) & (rows >= 0)
    stack, free_top = _push_free(state, rows, live)
    table = state.page_table.clone()
    table[seq] = torch.where(ok, -1, rows)
    residency = state.residency.clone()
    residency[seq] = torch.where(ok, COLD, state.residency[seq])
    return state._replace(
        page_table=table, free_stack=stack, free_top=free_top,
        residency=residency,
    ), k, v, ok


def swap_in(state: PagedKVState, cfg: PagedKVConfig, seq: int, k, v):
    """Restore a COLD sequence's pages (resume): allocate
    ``ceil(len / PS)`` fresh pages off the free-stack top (generally other
    ids than the evicted ones: the row is rebuilt), write the page data in
    place (none with ``k`` and ``v`` None: another data rank's slot) and
    mark it HOT. Returns ``(state, ok)``; ok False (state unchanged) when
    ``seq`` is not COLD or the pool cannot cover it."""
    npg = (state.lengths[seq] + cfg.page_size - 1) // cfg.page_size
    ok = (state.residency[seq] == COLD) & (state.lengths[seq] > 0) \
        & (npg <= state.free_top)
    cols = torch.arange(cfg.max_pages_per_seq, device=npg.device)
    take = ok & (cols < npg)
    src = torch.clamp(state.free_top - 1 - cols, 0,
                      state.free_stack.shape[0] - 1)
    pages = state.free_stack[src.long()]
    table = state.page_table.clone()
    table[seq] = torch.where(take, pages, state.page_table[seq])
    if k is not None:
        _write_pages(state.k_pages, pages, None, k, take)
        _write_pages(state.v_pages, pages, None, v, take)
    residency = state.residency.clone()
    residency[seq] = torch.where(ok, HOT, state.residency[seq])
    return state._replace(
        page_table=table, residency=residency,
        free_top=state.free_top - torch.where(ok, npg, 0).to(I32),
    ), ok


def _host_bits(t) -> np.ndarray:
    """``t``'s bits on the host as numpy (numpy has no bfloat16): a tensor,
    or a numpy array (the JAX package's bfloat16 ones included)."""
    if not isinstance(t, torch.Tensor):
        t = np.asarray(t)
        return t.view(np.int16) if t.dtype.name == "bfloat16" else t
    t = t.detach().cpu()
    if t.element_size() == 2:
        t = t.view(torch.int16)
    return t.numpy()


class HostColdTier:
    """Host-memory page store for evicted sequences: the slow tier of the
    server-memory hierarchy, held as numpy so the device loop can never
    touch it by accident. Pages are slab-allocated from a free list of
    ``host_pages``; each evicted slot owns a run of host pages, and
    ``order`` (eviction order) drives FIFO restore. Pages are kept as
    their bits (int16 for bf16), so any pool dtype round-trips exactly.

    With a ``placement.MemoryBudget`` attached, every store reserves
    ``cold:<slot>`` on the shared DRAM ledger and every drop releases it —
    the ledger the durability tier also reads, so KV eviction and flush
    placement see one pool. The tier is part of the persistence domain:
    :meth:`state_arrays` / :meth:`restore_arrays` round-trip the slabs and
    the allocator through the durability snapshot and WAL
    (``fault.recovery``), in the JAX package's layout.

    ``slots`` (a range; None = every slot) names the slots whose pages
    this tier parks: a data rank's. The allocator (host page ids, free
    list, eviction order, counters) runs for every slot, the same on
    every rank; the slabs and the budget take only the named slots'
    pages (the bytes this rank parks)."""

    def __init__(self, cfg: PagedKVConfig, host_pages: int,
                 dtype=torch.float32, budget=None, slots=None):
        self.cfg = cfg
        self.dtype = dtype
        self.host_pages = int(host_pages)
        shape = (cfg.layers, self.host_pages, cfg.page_size, cfg.kv_heads,
                 cfg.head_dim)
        bits = _host_bits(torch.empty((0,), dtype=dtype)).dtype
        self.k = np.zeros(shape, bits)
        self.v = np.zeros(shape, bits)
        self.free = list(range(self.host_pages))
        self.slot_pages: dict[int, list[int]] = {}  # slot -> host page ids
        self.order: list[int] = []  # eviction order (FIFO restore)
        self.evictions = 0
        self.restores = 0
        self.budget = budget
        self.budget_refusals = 0
        self.slots = slots

    def parks(self, slot: int) -> bool:
        """Whether this tier holds ``slot``'s page data."""
        return self.slots is None or int(slot) in self.slots

    @property
    def page_bytes(self) -> int:
        """Host bytes one parked page costs (k + v slabs)."""
        c = self.cfg
        return (2 * c.layers * c.page_size * c.kv_heads * c.head_dim
                * self.k.dtype.itemsize)

    @property
    def pages_used(self) -> int:
        return self.host_pages - len(self.free)

    def can_store(self, n_pages: int) -> bool:
        return n_pages <= len(self.free)

    def can_accept(self, slot: int, n_pages: int) -> bool:
        """Whether :meth:`store` would take ``slot``'s pages — free pages
        AND budget headroom — without reserving; checked before
        ``swap_out`` frees device pages, so a refusal never loses kv."""
        if int(slot) in self.slot_pages or not self.can_store(n_pages):
            return False
        if self.budget is not None and self.parks(slot) and \
                self.budget.free("dram") < n_pages * self.page_bytes:
            return False
        return True

    def store(self, slot: int, k, v, n_pages: int) -> bool:
        """Park ``n_pages`` of swap_out's (L, MaxP, PS, ...) buffers for
        ``slot``: the copy to the host happens here (for a slot this tier
        does not park, only its host page ids are taken)."""
        slot, n_pages = int(slot), int(n_pages)
        if slot in self.slot_pages or not self.can_store(n_pages):
            return False
        own = self.parks(slot)
        if self.budget is not None and own and not self.budget.reserve(
                f"cold:{slot}", n_pages * self.page_bytes):
            self.budget_refusals += 1
            return False
        ids = [self.free.pop() for _ in range(n_pages)]
        if own:
            kd, vd = _host_bits(k), _host_bits(v)
            for i, hp in enumerate(ids):
                self.k[:, hp] = kd[:, i]
                self.v[:, hp] = vd[:, i]
        self.slot_pages[slot] = ids
        self.order.append(slot)
        self.evictions += 1
        return True

    def load(self, slot: int):
        """``slot``'s stash as (k, v) CPU tensors of the pool dtype, padded
        to MaxP pages (tail zeros); the stash stays until :meth:`drop`."""
        ids = self.slot_pages[slot]
        mp = self.cfg.max_pages_per_seq
        shape = (self.cfg.layers, mp) + self.k.shape[2:]
        k = np.zeros(shape, self.k.dtype)
        v = np.zeros(shape, self.v.dtype)
        for i, hp in enumerate(ids):
            k[:, i] = self.k[:, hp]
            v[:, i] = self.v[:, hp]
        return (torch.from_numpy(k).view(self.dtype),
                torch.from_numpy(v).view(self.dtype))

    def drop(self, slot: int, *, restored: bool = False) -> None:
        """Free ``slot``'s host pages (after a restore, or when a cold slot
        is released)."""
        slot = int(slot)
        ids = self.slot_pages.pop(slot, None)
        if ids is None:
            return
        if self.budget is not None:
            self.budget.release(f"cold:{slot}")
        self.free.extend(ids)
        if slot in self.order:
            self.order.remove(slot)
        if restored:
            self.restores += 1

    # -- persistence-domain serialization (fault.recovery flush/recover) ----

    def _slabs(self, k: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(k.copy()).view(self.dtype)

    def state_arrays(self) -> dict[str, torch.Tensor]:
        """Snapshot the tier as fixed-shape CPU tensors (flush payload).

        Variable-length allocator state is padded with -1 sentinels, with
        list *order preserved* — the free list is a stack popped from the
        end and ``order`` drives FIFO restore, so recovery must reproduce
        both exactly for the restarted allocator to stay deterministic."""
        hp = self.host_pages
        slot_of = np.full((hp,), -1, np.int64)
        rank_of = np.zeros((hp,), np.int64)
        for slot, ids in self.slot_pages.items():
            for r, p in enumerate(ids):
                slot_of[p] = slot
                rank_of[p] = r
        free = np.full((hp,), -1, np.int64)
        if self.free:
            free[: len(self.free)] = np.asarray(self.free, np.int64)
        order = np.full((hp,), -1, np.int64)
        if self.order:
            order[: len(self.order)] = np.asarray(self.order, np.int64)
        return {
            "k": self._slabs(self.k),
            "v": self._slabs(self.v),
            "slot_of_page": torch.from_numpy(slot_of),
            "rank_of_page": torch.from_numpy(rank_of),
            "free_list": torch.from_numpy(free),
            "order": torch.from_numpy(order),
            "counters": torch.tensor([self.evictions, self.restores],
                                     dtype=torch.int64),
        }

    def zero_arrays(self) -> dict[str, torch.Tensor]:
        """A zeroed ``state_arrays`` tree — the restore template a fresh
        process hands to ``checkpoint.restore`` before replay."""
        hp = self.host_pages
        z = lambda n: torch.zeros((n,), dtype=torch.int64)  # noqa: E731
        return {
            "k": torch.zeros(self.k.shape, dtype=self.dtype),
            "v": torch.zeros(self.v.shape, dtype=self.dtype),
            "slot_of_page": z(hp), "rank_of_page": z(hp),
            "free_list": z(hp), "order": z(hp), "counters": z(2),
        }

    def restore_arrays(self, arrays) -> None:
        """Rebuild slabs + allocator from a recovered ``state_arrays`` tree
        (tensors, or the JAX package's numpy arrays)."""
        host = {k: _host_bits(v) for k, v in arrays.items()}
        self.k = np.array(host["k"], dtype=self.k.dtype)
        self.v = np.array(host["v"], dtype=self.v.dtype)
        slot_of, rank_of = host["slot_of_page"], host["rank_of_page"]
        ev, rs = host["counters"]
        by_slot: dict[int, list[tuple[int, int]]] = {}
        for p in range(self.host_pages):
            s = int(slot_of[p])
            if s >= 0:
                by_slot.setdefault(s, []).append((int(rank_of[p]), p))
        self.slot_pages = {
            s: [p for _r, p in sorted(v)] for s, v in by_slot.items()
        }
        self.free = [int(p) for p in host["free_list"] if p >= 0]
        self.order = [int(s) for s in host["order"] if s >= 0]
        self.evictions, self.restores = int(ev), int(rs)
        if self.budget is not None:
            self.budget.release_prefix("cold:")
            for s, ids in self.slot_pages.items():
                if self.parks(s):
                    self.budget.reserve(f"cold:{s}",
                                        len(ids) * self.page_bytes)


# ---------------------------------------------------------------------------
# Attention over the paged cache
# ---------------------------------------------------------------------------

def attend(state: PagedKVState, cfg: PagedKVConfig, layer: int, q, *,
           backend: Optional[str] = "auto"):
    """q: (B, KVH, G, HD) pre-scaled f32 -> (B, KVH, G, HD) f32. Dead
    table entries (-1) resolve to the zero sentinel inside the walk."""
    from repro_torch.kernels import ops as kops

    return kops.paged_attention(
        q, state.k_pages[layer], state.v_pages[layer], state.page_table,
        state.lengths, backend=backend,
    )
