"""GQA attention with the head-padding plan, chunked (flash-style) prefill
and cache-based decode.

Physical layout (``parallel/sharding.py``): query heads padded to
``plan.hp``, kv heads padded to ``plan.kvp`` and replicated ``plan.repl``
times; padded query-head outputs are masked to zero, so the function
equals the logical unpadded model; replicated kv heads are tied at init
and their gradients re-tied every step (:func:`tie_kv_grads`, across the
model ranks under tensor parallelism). Tensors
keep the JAX package's layouts: activations (B, S, H, hd), caches
(B, Smax, KV, hd), page pools (NP, PS, KV, hd).

Under Megatron tensor parallelism each rank holds ``plan.hp / tp`` query
heads and ``plan.kv_phys / tp`` stored kv heads (``wq``/``wk``/``wv`` and
the biases split on their head axis, ``wo`` on its first): rank r's q
head i feeds its kv head ``i // (hp / kv_phys)``, the same grouping as
the whole layout, so every function below runs unchanged on a rank's
heads; :func:`out_proj` masks the rank's slots and sums the partial
products over the model axis. When ``kv < tp`` each rank's kv heads are
replicas (``plan.repl``) of the logical ones its q heads read.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    apply_mrope, apply_rope, dtype_of, matmul, normal,
)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import HeadPlan

F32 = torch.float32
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _q_slot_map(plan: HeadPlan):
    """logical q head i -> physical padded slot."""
    g = plan.group
    return [((i // g) * plan.gp + (i % g)) for i in range(plan.h)]


def q_head_mask(plan: HeadPlan, device):
    """(hp,) 1.0 for slots holding a real query head."""
    mask = torch.zeros((plan.hp,), dtype=F32, device=device)
    mask[_q_slot_map(plan)] = 1.0
    return mask


def attn_init(gen, cfg: ModelConfig, plan: HeadPlan, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dt = dtype_of(cfg.dtype)
    std = 1.0 / (d ** 0.5)
    wq_l = normal(gen, (d, plan.h, hd), device) * std
    wk_l = normal(gen, (d, plan.kv, hd), device) * std
    wv_l = normal(gen, (d, plan.kv, hd), device) * std
    wq = torch.zeros((d, plan.hp, hd), dtype=F32, device=device)
    wq[:, _q_slot_map(plan)] = wq_l
    # kv: pad to kvp, then replicate each head `repl` times consecutively
    wk = torch.zeros((d, plan.kvp, hd), dtype=F32, device=device)
    wv = torch.zeros((d, plan.kvp, hd), dtype=F32, device=device)
    wk[:, :plan.kv] = wk_l
    wv[:, :plan.kv] = wv_l
    p = {
        "wq": wq.to(dt),
        "wk": torch.repeat_interleave(wk, plan.repl, dim=1).to(dt),
        "wv": torch.repeat_interleave(wv, plan.repl, dim=1).to(dt),
        "wo": (normal(gen, (plan.hp, hd, d), device) * std).to(dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((plan.hp, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((plan.kv_phys, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((plan.kv_phys, hd), dtype=dt, device=device)
    return p


def tie_kv_grads(grads_attn: dict, plan: HeadPlan, ctx=None) -> dict:
    """Average the gradients of each kv replication group (``plan.repl``
    consecutive heads), so replicated kv heads stay tied; the identity at
    ``repl == 1`` (one device). Gradients of the whole layout are tied in
    place. A tensor-parallel rank's blocks (``plan.kv_phys / tp`` kv
    heads: a group spans model ranks) are gathered over ``ctx``'s model
    axis, tied, and this rank's block taken back, so every rank holding a
    replica holds the same bits."""
    if plan.repl == 1:
        return grads_attn
    out = dict(grads_attn)
    for name in ("wk", "wv", "bk", "bv"):
        if name not in out:
            continue
        g = out[name]
        ax = g.dim() - 2  # the kv-head axis: (..., kv_phys, head_dim)
        blocks = g.shape[ax] != plan.kv_phys and coll.tensor_parallel(ctx)
        if blocks:
            g = coll.model_gather(g, ctx, ax)
        shape = list(g.shape)
        assert shape[ax] == plan.kv_phys, (name, shape, plan)
        grouped = g.reshape(shape[:ax] + [plan.kvp, plan.repl]
                            + shape[ax + 1:])
        mean = grouped.mean(dim=ax + 1, keepdim=True)
        tied = mean.expand(grouped.shape).reshape(g.shape)
        out[name] = coll.model_block(tied, ctx, ax).contiguous() \
            if blocks else tied
    return out


# ---------------------------------------------------------------------------
# QKV and output projections
# ---------------------------------------------------------------------------

def _proj(x, w):
    """x (B, S, D) through w (D, heads, hd) -> (B, S, heads, hd) f32."""
    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def qkv(params, x, cfg: ModelConfig, plan: HeadPlan, positions, ctx=None):
    """x: (B, S, D) -> q (B,S,hp,hd), k/v (B,S,kv_phys,hd), rope applied,
    in the config's dtype. Under tensor parallelism ``x`` enters the
    rank's head-split products through ``collectives.model_copy``."""
    x = coll.model_copy(x, ctx)
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].float()
        k = k + params["bk"].float()
        v = v + params["bv"].float()
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.rope_theta)
    else:
        pos = positions if positions.dim() == 2 else positions[0]
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    dt = dtype_of(cfg.dtype)
    return q.to(dt), k.to(dt), v.to(dt)


def local_q_mask(plan: HeadPlan, heads: int, ctx, device):
    """The slice of :func:`q_head_mask` over this rank's ``heads`` query
    slots: the whole mask at tp 1, rank r's ``plan.hp / tp`` slots from
    ``r * plan.hp / tp`` under tensor parallelism."""
    lo = coll.model_rank(ctx) * heads
    return q_head_mask(plan, device)[lo:lo + heads]


def out_proj(params, attn_out, plan: HeadPlan, ctx=None, seq_dim=None):
    """attn_out: (B, S, hp, hd) -> (B, S, D), masking padded q slots.
    Under tensor parallelism ``attn_out`` and ``wo`` hold this rank's
    ``hp / tp`` heads, and the f32 partial product is summed over the
    model axis before the cast (with ``seq_dim``, reduce-scattered along
    the sequence)."""
    b, s, h, k = attn_out.shape
    mask = local_q_mask(plan, h, ctx, attn_out.device).to(attn_out.dtype)
    attn_out = attn_out * mask[None, None, :, None]
    wo = params["wo"]
    y = matmul(attn_out.reshape(b, s, h * k), wo.reshape(h * k, wo.shape[-1]))
    return coll.model_reduce(y, ctx, seq_dim).to(attn_out.dtype)


# ---------------------------------------------------------------------------
# Masked full attention (training path for moderate S)
# ---------------------------------------------------------------------------

TRAIN_FULL_ATTN_MAX = 8192


def full_attention(q, k, v, *, window: int = 0):
    """q: (B,S,H,hd); k/v: (B,S,KV,hd). Causal (optionally windowed)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.float().reshape(B, S, KV, G, hd) * hd ** -0.5
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float())
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return out.reshape(B, S, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Chunked causal attention (online softmax, the plain prefill path)
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, q_offset=0, window: int = 0,
                      chunk: int = 512):
    """Online-softmax chunked causal attention.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) with H % KV == 0.
    ``q_offset``: absolute position of q[0] relative to k[0]. ``window``:
    sliding-window size (0 = full causal). Loops over q chunks (outer) and
    kv chunks (inner) so only (B, C, H, C) score tiles materialise; with a
    window only ``window // chunk + 2`` kv chunks are visited per q chunk,
    and kv chunks wholly after a q chunk are skipped (they would add
    exactly zero).
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    assert H % KV == 0
    G = H // KV
    C = min(chunk, Sq, Sk)
    pq, pk = (-Sq) % C, (-Sk) % C
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = q.shape[1] // C, k.shape[1] // C
    scale = hd ** -0.5
    qc = q.reshape(B, nq, C, H, hd)
    kc = k.reshape(B, nk, C, KV, hd)
    vc = v.reshape(B, nk, C, KV, hd)
    wk_chunks = min(nk, window // C + 2) if window else nk
    base = torch.arange(C, device=q.device)

    outs = []
    for qi in range(nq):
        qblk = qc[:, qi].float() * scale  # (B, C, H, hd)
        qg = qblk.reshape(B, C, KV, G, hd)
        q_pos = q_offset + qi * C + base
        last = min((q_offset + qi * C + C - 1) // C, nk - 1)
        if window:
            start = min(max(last - (wk_chunks - 1), 0), nk - wk_chunks)
        else:
            start = 0
        m = torch.full((B, C, KV, G), NEG_INF, dtype=F32, device=q.device)
        l = torch.zeros((B, C, KV, G), dtype=F32, device=q.device)
        acc = torch.zeros((B, C, KV, G, hd), dtype=F32, device=q.device)
        for j in range(start, min(start + wk_chunks, last + 1)):
            k_pos = j * C + base
            s = torch.einsum("bqkgh,bckh->bqkgc", qg, kc[:, j].float())
            causal = q_pos[:, None] >= k_pos[None, :]
            if window:
                causal &= q_pos[:, None] - k_pos[None, :] < window
            s = torch.where(causal[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgc,bckh->bqkgh", p, vc[:, j].float())
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.reshape(B, C, H, hd))
    out = torch.cat(outs, dim=1)[:, :Sq]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------

def merge_fresh_token(acc, m, l, s_cur, v_new):
    """LSE-merge online-softmax stats over a *stale* cache with the current
    token's not-yet-written k/v, then normalise.

    acc: (B, KV, G, hd) f32 unnormalised Σ exp(s - m) v over the cache;
    m/l: (B, KV, G) row max and normaliser; s_cur: (B, KV, G) the current
    token's pre-scaled q·k_new; v_new: (B, KV, hd). Returns (B, KV, G, hd)
    f32: the attention that writing the token first would give. An empty
    cache (m = NEG_INF, l = 0) attends the fresh token alone.
    """
    m_t = torch.maximum(m, s_cur)
    corr = torch.exp(m - m_t)
    p_cur = torch.exp(s_cur - m_t)
    l_t = l * corr + p_cur
    acc_t = acc * corr[..., None] + p_cur[..., None] * v_new.float()[:, :, None, :]
    return acc_t / torch.clamp(l_t, min=1e-30)[..., None]


def paged_decode_attention_ro(q, k_pages, v_pages, page_table, lengths,
                              k_new, v_new, *, backend="auto"):
    """Read-only decode attention against a paged KV pool.

    The pool is *stale*: it holds the first ``lengths`` committed tokens
    and is never written here. The stats walk (``paged_attention_stats``:
    the CUDA kernel, or its plain version per ``backend``) covers the stale
    pages; the current token's fresh k_new/v_new ((B, KV, hd)) is folded
    in by :func:`merge_fresh_token`. q: (B, 1, H, hd); pages:
    (NP, PS, KV, hd); page_table: (B, MaxP) int32 (-1 = unmapped, resolved
    to the pool's zero sentinel inside the walk). Returns (B, 1, H, hd) in
    q's dtype.
    """
    from repro_torch.kernels import ops as kops

    B, _, H, hd = q.shape
    KV = k_pages.shape[2]
    G = H // KV
    qg = (q[:, 0].reshape(B, KV, G, hd).float() * hd ** -0.5).contiguous()
    acc, m, l = kops.paged_attention_stats(
        qg, k_pages, v_pages, page_table, lengths, backend=backend)
    s_cur = torch.einsum("bkgh,bkh->bkg", qg, k_new.float())
    out = merge_fresh_token(acc, m, l, s_cur, v_new)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           backend="auto"):
    """Decode attention against a paged KV pool whose new token's kv is
    already written at ``lengths - 1``. Returns (B, 1, H, hd) in q's
    dtype."""
    from repro_torch.kernels import ops as kops

    B, _, H, hd = q.shape
    KV = k_pages.shape[2]
    G = H // KV
    qg = (q[:, 0].reshape(B, KV, G, hd).float() * hd ** -0.5).contiguous()
    out = kops.paged_attention(qg, k_pages, v_pages, page_table, lengths,
                               backend=backend)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, *, window: int = 0):
    """q: (B, 1, H, hd); caches: (B, Smax, KV, hd); lengths: (B,) valid len
    (the new token's k/v already written at ``lengths - 1``)."""
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q[:, 0].reshape(B, KV, G, hd).float() * hd ** -0.5
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float())
    pos = torch.arange(Smax, device=q.device)[None, :]
    valid = pos < lengths[:, None]
    if window:
        valid &= pos >= (lengths[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Full attention module forward (prefill / train and decode)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Smax, kv_phys, hd)
    v: torch.Tensor


def attention_block(params, x, cfg: ModelConfig, plan: HeadPlan, positions,
                    *, cache: Optional[KVCache] = None, lengths=None,
                    chunk: int = 512):
    """Returns (y, new_cache). Train/prefill when cache is None or being
    filled from empty; decode when x has seq 1 and a cache is given."""
    q, k, v = qkv(params, x, cfg, plan, positions)
    S = x.shape[1]
    if cache is None:
        out = chunked_attention(q, k, v, window=cfg.sliding_window,
                                chunk=chunk)
        return out_proj(params, out, plan), None
    if S == 1:
        # decode: write the new k/v at lengths - 1, attend over the cache
        rows = torch.arange(x.shape[0], device=x.device)
        k_cache = cache.k.clone()
        v_cache = cache.v.clone()
        k_cache[rows, (lengths - 1).long()] = k[:, 0]
        v_cache[rows, (lengths - 1).long()] = v[:, 0]
        out = decode_attention(q, k_cache, v_cache, lengths,
                               window=cfg.sliding_window)
        return out_proj(params, out, plan), KVCache(k_cache, v_cache)
    out = chunked_attention(q, k, v, window=cfg.sliding_window, chunk=chunk)
    k_cache, v_cache = cache.k, cache.v
    if S <= k_cache.shape[1]:
        k_cache = k_cache.clone()
        v_cache = v_cache.clone()
        k_cache[:, :S] = k
        v_cache[:, :S] = v
    return out_proj(params, out, plan), KVCache(k_cache, v_cache)
