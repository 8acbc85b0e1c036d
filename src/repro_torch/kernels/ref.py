"""Plain PyTorch versions of the kernels: what the CPU runs, and what
``chip_smoke.py`` holds each CUDA kernel against on the card.

Each has the signature and the sentinel semantics of its counterpart in
the JAX package's ``kernels/ref.py``. The integer state arrays use the
sentinel-resident layout: the last row of ``bucket_keys``, ``bucket_ptr``,
``pool`` and the cache arrays (``KVState``), and of a replica's ``log``
and ``store`` (``ReplicaState``), is an all-zero pad row that absorbs
dropped writes.
"""
from __future__ import annotations

import torch

I32 = torch.int32
F32 = torch.float32


def hash_probe(bucket_keys, bucket_ptr, keys, h1, h2):
    """Two-bucket existence probe (the first two of a GET/PUT's memory
    accesses). A way matches where its key words equal the query and its
    pointer is >= 0. Returns (found (B,) bool, ptr (B,) int32): the max
    matching pointer of the primary bucket if it matched, else of the
    overflow bucket; 0 where missed."""
    def one(bids):
        bk = bucket_keys[bids]
        bp = bucket_ptr[bids]
        eq = torch.all(bk == keys[:, None, :], dim=-1) & (bp >= 0)
        hit = torch.any(eq, dim=-1)
        ptr = torch.max(torch.where(eq, bp, -1), dim=-1).values
        return hit, ptr

    hit1, p1 = one(h1)
    hit2, p2 = one(h2)
    found = hit1 | hit2
    ptr = torch.where(hit1, p1, p2)
    return found, torch.where(found, ptr, 0).to(I32)


def fetch(pool, ptr):
    """Gather pool rows at pre-clamped pointers (misses point at the
    resident zero sentinel row NP). pool: (NP + 1, VW); ptr: (B,)."""
    return pool[ptr]


def cache_probe(cache_keys, cache_vals, cache_meta, keys, cset):
    """Hot-set cache lookup. cache_keys: (CS + 1, CW, KW); cache_vals:
    (CS + 1, CW, VW); cache_meta: (CS + 1, CW) (meta == 0 marks an empty
    way, so the zero sentinel row can never hit); keys: (B, KW); cset: (B,).

    Returns (hit (B,) bool, way (B,) int32, vals (B, VW)): the max matching
    way and that way's value line, both 0 where missed."""
    ck = cache_keys[cset]  # (B, CW, KW)
    cm = cache_meta[cset]  # (B, CW)
    eq = torch.all(ck == keys[:, None, :], dim=-1) & (cm > 0)
    hit = torch.any(eq, dim=-1)
    cw = cm.shape[1]
    iota = torch.arange(cw, dtype=I32, device=keys.device)[None, :]
    way = torch.max(torch.where(eq, iota, -1), dim=-1).values
    way = torch.where(hit, way, 0).to(I32)
    vals = torch.where(hit[:, None], cache_vals[cset, way], 0)
    return hit, way, vals


def hash_get(bucket_keys, bucket_ptr, pool, keys, h1, h2):
    """Two-bucket probe + value fetch. Returns (vals, found). Misses read
    the pool's resident zero sentinel row (last row) — never a live row."""
    found, ptr = hash_probe(bucket_keys, bucket_ptr, keys, h1, h2)
    np_ = pool.shape[0] - 1
    vals = fetch(pool, torch.where(found, torch.clamp(ptr, 0, np_), np_))
    return torch.where(found[:, None], vals, 0), found


def commit_buckets(bucket_keys, bucket_ptr, keys, tb, tw, bptr_val):
    """PUT scatter pass 1, IN PLACE: way ``tw[i]`` of bucket ``tb[i]`` <-
    (keys[i], bptr_val[i]). Entries aimed at the sentinel row (tb == NB)
    write zeros, so the sentinel stays zero. Returns the two arrays."""
    nb = bucket_keys.shape[0] - 1
    drop = tb >= nb
    bucket_keys[tb, tw] = torch.where(drop[:, None], 0, keys)
    bucket_ptr[tb, tw] = torch.where(drop, 0, bptr_val)
    return bucket_keys, bucket_ptr


def write_rows(pool, vals, wp):
    """PUT scatter pass 2, IN PLACE: pool row ``wp[i]`` <- vals[i]. Entries
    aimed at the sentinel row (wp == NP) write zeros. Returns the pool."""
    np_ = pool.shape[0] - 1
    pool[wp] = torch.where((wp >= np_)[:, None], 0, vals)
    return pool


def hash_put(bucket_keys, bucket_ptr, pool, keys, vals, tb, tw, bptr_val, wp):
    """Commit phase of a planned batched PUT (see ``kvstore.plan_put``),
    IN PLACE, as the CUDA commit kernels are: ``bucket_keys``,
    ``bucket_ptr`` and ``pool`` are written and returned. tb/tw: (B,)
    target bucket/way (tb == NB = the sentinel); bptr_val: (B,) pool
    pointer to store; wp: (B,) pool row for the value (wp == NP = the
    sentinel). Sentinel-targeted payloads are zeroed, so dropped duplicates
    all write the same zeros and the sentinel rows stay zero. Live targets
    are unique by the plan's construction, so the result does not depend
    on write order."""
    commit_buckets(bucket_keys, bucket_ptr, keys, tb, tw, bptr_val)
    write_rows(pool, vals, wp)
    return bucket_keys, bucket_ptr, pool


# ---------------------------------------------------------------------------
# ORCA-TX: the fused replica commit (log append + store scatter)
# ---------------------------------------------------------------------------

def tx_commit(log, store, batch, values, slot, rows):
    """Fused ORCA-TX replica commit (see ``core.transaction.plan_commit``),
    IN PLACE, as the CUDA kernel is: ``log`` and ``store`` are written and
    returned. log: (LC + 1, TW); store: (NK + 1, VW) — the
    ``ReplicaState`` sentinel-resident layout (last row = the zero
    sentinel). batch: (B, TW) raw log records; values: (B, M, VW); slot:
    (B,) absolute log slot (LC = the sentinel); rows: (B*M,) store row per
    op (NK = the sentinel). The plan makes live targets unique, so both
    scatters are conflict-free; sentinel-targeted payloads are zeroed, so
    dead duplicates write identical zeros and the sentinel rows stay zero.
    """
    lc = log.shape[0] - 1
    nk = store.shape[0] - 1
    vals = values.reshape(-1, values.shape[-1])
    log[slot] = torch.where((slot >= lc)[:, None], 0, batch)
    store[rows] = torch.where((rows >= nk)[:, None], 0, vals)
    return log, store


def tx_commit_chain(log, store, batch, values, slot, rows):
    """Whole-chain commit, IN PLACE: :func:`tx_commit` on every replica of
    a local chain in one batched dual scatter. log: (R, LC + 1, TW); store:
    (R, NK + 1, VW); batch: (B, TW) and values: (B, M, VW) shared by every
    replica; slot: (R, B) per-replica absolute log slot (LC = the
    sentinel); rows: (B*M,) store row per op shared by every replica, or
    (R, B*M) per replica (chain shortening points a dead replica's ops at
    its own sentinel row). Returns the (log, store) tensors."""
    r = log.shape[0]
    lc = log.shape[1] - 1
    nk = store.shape[1] - 1
    vals = values.reshape(-1, values.shape[-1])
    if rows.dim() == 1:
        rows = rows[None, :].expand(r, -1)
    ridx = torch.arange(r, device=log.device)[:, None]
    log[ridx, slot] = torch.where((slot >= lc)[..., None], 0, batch[None])
    store[ridx, rows] = torch.where((rows >= nk)[..., None], 0, vals[None])
    return log, store


# ---------------------------------------------------------------------------
# ORCA-DLRM: the embedding reduction
# ---------------------------------------------------------------------------

def embedding_reduce(table, idx, seg_ids, num_segments: int):
    """Gather + segment sum: (R, D), (N,), (N,) -> (num_segments, D) f32.

    ``seg_ids`` is non-decreasing. Each segment sums its rows in lookup
    order starting from its first row (converted to f32), never from +0.0
    — the order of the Pallas kernel's per-segment accumulator and of
    :func:`dlrm_embedding_reduce`, so the sums agree bit for bit. Segments
    with no entries are zero (the zeroing ``ops.embedding_reduce`` adds to
    the Pallas kernel)."""
    n = idx.shape[0]
    dev = table.device
    if n == 0:
        return torch.zeros((num_segments, table.shape[1]), dtype=F32,
                           device=dev)
    rows = table[idx].to(F32)  # (N, D)
    seg = seg_ids.to(torch.int64)
    ids = torch.arange(num_segments, dtype=torch.int64, device=dev)
    start = torch.searchsorted(seg, ids)
    count = torch.searchsorted(seg, ids, right=True) - start
    nonempty = (count > 0)[:, None]
    last = n - 1
    out = torch.where(nonempty, rows[torch.clamp(start, max=last)], 0.0)
    longest = int(count.max()) if num_segments else 0
    for j in range(1, longest):
        more = (count > j)[:, None]
        out = torch.where(more, out + rows[torch.clamp(start + j, max=last)],
                          out)
    return out


def dlrm_embedding_reduce(tables, idx):
    """DLRM-shaped reduction: (T, R', D), (B, T, L) -> (B, T, D) f32.

    Lookups are added one after another, starting from the first — the
    association order of a per-row walk over the lookup list, which the
    JAX package pins (``kernels/ref.py``), so the f32 sums agree with it
    and with the CUDA kernel bit for bit."""
    t_ids = torch.arange(tables.shape[0], device=tables.device)[None, :, None]
    g = tables[t_ids, idx].to(F32)  # (B, T, L, D)
    out = g[:, :, 0]
    for j in range(1, g.shape[2]):
        out = out + g[:, :, j]
    return out


# ---------------------------------------------------------------------------
# LM serving: paged decode attention and causal prefill attention
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def paged_attention_stats(q, k_pages, v_pages, page_table, lengths):
    """Online-softmax stats over the paged pool: (acc = Σ exp(s - m) v,
    m = row max, l = Σ exp(s - m)), all f32.

    q: (B, KVH, G, hd) f32, pre-scaled; pages: (NP, PS, KVH, hd) f32 or
    bf16; page_table: (B, MaxP) int32 whose entries < 0 (unmapped) resolve
    to the last physical page, the pool's zero sentinel; lengths: (B,).
    Only the first ``lengths`` positions count. A zero-length sequence
    yields (0, NEG_INF, 0): the empty softmax, safe to LSE-merge."""
    return _range_stats(q, k_pages, v_pages, page_table,
                        torch.zeros_like(lengths), lengths)


def paged_attention_stats_splits(q, k_pages, v_pages, page_table, lengths,
                                 splits: int):
    """The CUDA kernel's split walk, plainly: the online-softmax stats of
    each of ``splits`` contiguous token ranges [r T, (r + 1) T), T =
    ceil(MaxP PS / splits), clipped to each sequence's length. Returns
    (acc (S, B, KVH, G, hd), m (S, B, KVH, G), l (S, B, KVH, G)); a range
    past the length holds the empty state (0, NEG_INF, 0). Tests hold it,
    merged by :func:`merge_stats`, against the JAX package; the main path
    does not use it."""
    maxp, ps = page_table.shape[1], k_pages.shape[1]
    t = max(1, -(-maxp * ps // splits))
    length = torch.clamp(lengths, 0, maxp * ps)
    accs, ms, ls = [], [], []
    for r in range(splits):
        lo = torch.clamp(length, max=r * t)
        hi = torch.clamp(length, max=(r + 1) * t)
        acc, m, l = _range_stats(q, k_pages, v_pages, page_table, lo, hi)
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    return torch.stack(accs), torch.stack(ms), torch.stack(ls)


def _range_stats(q, k_pages, v_pages, page_table, lo, hi):
    """The stats over the positions [lo, hi) of each sequence (lo, hi:
    (B,))."""
    b, kvh, g, hd = q.shape
    np_, ps = k_pages.shape[0], k_pages.shape[1]
    maxp = page_table.shape[1]
    pt = torch.where(page_table < 0, np_ - 1,
                     torch.clamp(page_table, 0, np_ - 1)).long()
    kk = k_pages[pt].reshape(b, maxp * ps, kvh, hd)
    vv = v_pages[pt].reshape(b, maxp * ps, kvh, hd)
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), kk.float())
    pos = torch.arange(maxp * ps, device=q.device)[None, :]
    valid = ((pos >= lo[:, None]) & (pos < hi[:, None]))[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1)
    # exp through the mask: an all-masked row has m == NEG_INF, where
    # exp(s - m) would be 1 per position
    pexp = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = pexp.sum(dim=-1)
    acc = torch.einsum("bkgs,bskh->bkgh", pexp, vv.float())
    return acc, m, l


def merge_stats(acc, m, l):
    """LSE-merge online-softmax states stacked on dim 0, as the kernel's
    cluster merge does: m = max m_r, l = sum l_r exp(m_r - m), acc = sum
    acc_r exp(m_r - m). All-empty rows stay exactly (0, NEG_INF, 0)."""
    mx = m.amax(dim=0)
    w = torch.exp(m - mx[None])
    return (acc * w[..., None]).sum(dim=0), mx, (l * w).sum(dim=0)


def flash_attention(q, k, v, *, window: int = 0):
    """Causal (optionally windowed) attention with GQA, softmax over the
    whole row in f32. q: (B, H, S, hd); k, v: (B, KVH, S, hd); query head
    h reads kv head h // (H // KVH). Returns (B, H, S, hd) in q's dtype."""
    b, h, s, hd = q.shape
    kvh = k.shape[1]
    g = h // kvh
    qf = q.float().reshape(b, kvh, g, s, hd) * (hd ** -0.5)
    sc = torch.einsum("bkgqh,bksh->bkgqs", qf, k.float())
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    sc = torch.where(mask[None, None, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return out.reshape(b, h, s, hd).to(q.dtype)
