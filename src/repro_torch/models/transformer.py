"""Decoder blocks and the layer stack, for all six families: dense, MoE,
vlm (M-RoPE) and audio (codebooks) attention blocks, the attention-free
RWKV6 block (ssm) and the attention + Mamba block (hybrid).

The JAX package scans one block over L-stacked parameters; here the
stacked layout is kept (every leaf of ``params["layers"]`` has a leading
L dimension, so parameters cross from JAX unchanged) and the scan is a
Python loop over layer views: :func:`stack_apply` for serving,
:func:`stack_train` (with the MoE aux loss and remat) for training.

Megatron tensor parallelism (a context whose model axis has more than
one rank, each holding its blocks: ``sharding.param_blocks``) serves
every family and trains the dense and MoE ones: each block works on its
rank's heads and ``d_ff`` block and sums over the model axis after
``out_proj`` and the MLP; an MoE block takes the JAX package's dispatch
(``ep_shardmap``: :func:`moe.moe_apply_ep_shardmap` or
:func:`moe.moe_apply_tp_shardmap` for a stateless or prefill block, else
:func:`moe.moe_apply`); and with ``ctx.sp`` a stateless stack keeps the
residual split over the sequence on the model axis between the blocks
(Megatron sequence parallelism: gathered before attention and the MLP,
reduce-scattered after them). The RWKV6 block runs its time mix on the
rank's heads (``ssm.rwkv_tmix_apply``) and gathers its channel mix's
column blocks (``ssm.rwkv_cmix_apply``); the hybrid's Mamba branch,
replicated, runs whole on every rank and joins attention after
``out_proj``'s sum, its state gathered from (and cut back to) the
rank's heads where :func:`mamba_state_split` says the model axis splits
it.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    dtype_of, mlp_apply, mlp_init, rmsnorm, rmsnorm_init,
)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import HeadPlan, ParallelContext, head_plan
from repro_torch.tree import tree_map

F32 = torch.float32


def plan_for(cfg: ModelConfig, ctx: ParallelContext) -> HeadPlan:
    return head_plan(cfg.num_heads, cfg.num_kv_heads, max(ctx.tp, 1))


FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")


def check_family(cfg: ModelConfig) -> None:
    """Refuse a family the port does not know."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: unknown family {cfg.family!r} (the port runs "
            f"{', '.join(FAMILIES)})"
        )


TP_TRAIN_FAMILIES = ("dense", "moe")  # trained under tensor parallelism


def check_tp(cfg: ModelConfig, ctx: ParallelContext) -> None:
    """Refuse what tensor parallelism does not run: fsdp (the params'
    data-axis blocks), and an RWKV6 model whose heads the model axis does
    not divide (its time-mix projections split on heads)."""
    check_family(cfg)
    if ctx.mesh is not None and ctx.fsdp:
        raise NotImplementedError("fsdp parameter blocks are not ported")
    if coll.tensor_parallel(ctx) and cfg.family == "ssm" \
            and ssm_mod._heads(cfg)[0] % ctx.tp:
        raise NotImplementedError(
            f"{cfg.name}: {ssm_mod._heads(cfg)[0]} RWKV6 heads do not "
            f"split over {ctx.tp} model ranks")


def check_tp_train(cfg: ModelConfig, ctx: ParallelContext) -> None:
    """:func:`check_tp`, and refuse training under tensor parallelism of
    a family other than dense and MoE: the backward of the RWKV6 block's
    gathers and of the replicated Mamba branch is not ported
    (``ROADMAP.md`` queue 1, item 3b)."""
    check_tp(cfg, ctx)
    if coll.tensor_parallel(ctx) and cfg.family not in TP_TRAIN_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: training under tensor parallelism runs the "
            f"{' and '.join(TP_TRAIN_FAMILIES)} families, not {cfg.family} "
            f"(ROADMAP.md queue 1, item 3b)")


def mamba_state_split(cfg: ModelConfig, ctx: ParallelContext) -> bool:
    """Whether a rank holds its block of the hybrid's Mamba state heads
    (``din / 64``): under tensor parallelism when the model axis divides
    them, as ``model.decode_state_specs`` splits them. The branch's
    parameters are replicated, so every rank gathers the whole state
    before the branch and keeps its block after it."""
    return cfg.family == "hybrid" and coll.tensor_parallel(ctx) \
        and (cfg.d_model * cfg.ssm_expand // 64) % ctx.tp == 0


# ---------------------------------------------------------------------------
# Block init
# ---------------------------------------------------------------------------

def block_init(gen, cfg: ModelConfig, plan: HeadPlan, device):
    check_family(cfg)
    dt = dtype_of(cfg.dtype)
    d = cfg.d_model
    if cfg.family == "ssm":  # rwkv6
        return {
            "ln1": rmsnorm_init(d, dt, device),
            "tmix": ssm_mod.rwkv_tmix_init(gen, cfg, device),
            "ln2": rmsnorm_init(d, dt, device),
            "cmix": ssm_mod.rwkv_cmix_init(gen, cfg, device),
        }
    p = {
        "ln1": rmsnorm_init(d, dt, device),
        "attn": attn_mod.attn_init(gen, cfg, plan, device),
        "ln2": rmsnorm_init(d, dt, device),
    }
    if cfg.family == "hybrid":
        p["ssm"] = ssm_mod.mamba_init(gen, cfg, device)
    if cfg.is_moe:
        p["moe"] = moe_mod.moe_init(gen, cfg, device)
    else:
        p["mlp"] = mlp_init(gen, cfg, device)
    return p


def layer(tree, i: int):
    """Layer ``i``'s view of an L-stacked tree."""
    return tree_map(lambda t: t[i], tree)


def stack(trees):
    """L per-layer trees -> one L-stacked tree."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)


# ---------------------------------------------------------------------------
# Decode-time per-layer state
# ---------------------------------------------------------------------------

def layer_state_zeros(cfg: ModelConfig, plan: HeadPlan, batch: int,
                      cache_len: int, device, ctx=None):
    """Per-layer decode state. Attention caches are rings over
    ``cache_len`` slots (the sliding window when set); ``pos`` holds the
    absolute position in each slot (-1 = empty). The recurrent states
    ``s`` are f32 whatever the dtype: ssm (B, H, hd, hd) with the token
    shifts ``tshift``/``cshift`` (B, D); hybrid (B, din / 64, ssm_state,
    64) beside its attention ring. Under tensor parallelism the rings
    hold this rank's ``plan.kv_phys / tp`` kv heads, and ``s`` its heads
    of an ssm state, or of a hybrid's where :func:`mamba_state_split`
    (``model.decode_state_specs``)."""
    check_family(cfg)
    dt = dtype_of(cfg.dtype)
    hd = cfg.resolved_head_dim
    if cfg.family == "ssm":
        h, shd = ssm_mod._heads(cfg)
        if coll.tensor_parallel(ctx):  # check_tp: the model axis divides h
            h //= ctx.tp
        return {
            "s": torch.zeros((batch, h, shd, shd), dtype=F32, device=device),
            "tshift": torch.zeros((batch, cfg.d_model), dtype=dt,
                                  device=device),
            "cshift": torch.zeros((batch, cfg.d_model), dtype=dt,
                                  device=device),
        }
    sc = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    kv = plan.kv_phys // (ctx.tp if coll.tensor_parallel(ctx) else 1)
    if cfg.kv_cache_layout == "dot":
        k = torch.zeros((batch, kv, hd, sc), dtype=dt, device=device)
        v = torch.zeros((batch, kv, sc, hd), dtype=dt, device=device)
    else:
        k = torch.zeros((batch, sc, kv, hd), dtype=dt, device=device)
        v = torch.zeros((batch, sc, kv, hd), dtype=dt, device=device)
    st = {"k": k, "v": v,
          "pos": torch.full((batch, sc), -1, dtype=torch.int32,
                            device=device)}
    if cfg.family == "hybrid":
        hm = cfg.d_model * cfg.ssm_expand // 64
        if mamba_state_split(cfg, ctx):
            hm //= ctx.tp
        st["s"] = torch.zeros((batch, hm, cfg.ssm_state, 64), dtype=F32,
                              device=device)
    return st


def _cur_pos(positions):
    """The decoding token's (B,) positions from (B, 1) or M-RoPE's
    (3, B, 1)."""
    return positions[0, :, 0] if positions.dim() == 3 else positions[:, 0]


def token_positions(cfg: ModelConfig, cur_pos):
    """(B,) positions as qkv takes them: (B, 1), or (3, B, 1) for
    M-RoPE (the text stub: t = h = w)."""
    pos = cur_pos[:, None]
    return pos.expand(3, *pos.shape) if cfg.mrope else pos


# ---------------------------------------------------------------------------
# Attention decode against the shared page pool (serving.kv_cache)
# ---------------------------------------------------------------------------

class PagedAux(NamedTuple):
    """The per-step paged-decode context shared by every layer: the page
    walk is per sequence, not per layer. ``lengths`` counts only committed
    tokens (the current token's kv is appended after the last layer, one
    batched scatter for all layers); ``backend`` is the kernel knob
    (auto | cuda | ref). Unmapped (-1) entries, of COLD sequences or free
    slots, resolve to the pool's zero sentinel page inside the walk."""

    page_table: Any  # (B, MaxP) int32, -1 = unmapped
    lengths: Any  # (B,) committed tokens (excludes the current one)
    backend: Optional[str] = "auto"


def _paged_decode_attn_ro(params, x, cfg, plan, state, cur_pos,
                          paged: PagedAux, ctx=None):
    """x: (B,1,D); state: {"kp","vp"} (NP+1, PS, kvp, hd), one layer's
    page slice, read only. Attends over the stale pool through the stats
    walk and LSE-merges the current token's fresh k/v. Returns
    (y, {"k_new", "v_new"}) with the (B, kvp, hd) new kv. Under tensor
    parallelism on the rank's heads and its pool's kv heads."""
    q, k, v = attn_mod.qkv(params, x, cfg, plan,
                           token_positions(cfg, cur_pos), ctx)
    k_new, v_new = k[:, 0], v[:, 0]
    out = attn_mod.paged_decode_attention_ro(
        q, state["kp"], state["vp"], paged.page_table, paged.lengths,
        k_new, v_new, backend=paged.backend,
    )
    return attn_mod.out_proj(params, out, plan, ctx), {"k_new": k_new,
                                                       "v_new": v_new}


# ---------------------------------------------------------------------------
# Attention decode against a ring cache with per-slot positions
# ---------------------------------------------------------------------------

def _qg(q, kvp, scale, cfg, cache_dtype):
    B, _, H, hd = q.shape
    qg = q[:, 0].reshape(B, kvp, H // kvp, hd)
    if cfg.decode_mxu_einsum:
        # the JAX package's bf16 dots: q rounded to the cache dtype, the
        # products accumulated in f32
        return (qg * scale).to(cache_dtype).float()
    return qg.float() * scale


def _ring_decode_attn(params, x, cfg, plan, state, cur_pos, ctx=None):
    """x: (B,1,D); state k/v: (B,Sc,kvp,hd); cur_pos: (B,) position of the
    new token. Writes the token into its ring slot, attends. Returns
    (y, new_state). Under tensor parallelism on the rank's heads."""
    q, k, v = attn_mod.qkv(params, x, cfg, plan,
                           token_positions(cfg, cur_pos))
    sc = state["k"].shape[1]
    rows = torch.arange(x.shape[0], device=x.device)
    slot = (cur_pos % sc).long()
    k_cache, v_cache = state["k"].clone(), state["v"].clone()
    k_cache[rows, slot] = k[:, 0]
    v_cache[rows, slot] = v[:, 0]
    pos = state["pos"].clone()
    pos[rows, slot] = cur_pos.to(pos.dtype)

    B, _, H, hd = q.shape
    kvp = k_cache.shape[2]
    qg = _qg(q, kvp, hd ** -0.5, cfg, k_cache.dtype)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float())
    valid = (pos >= 0) & (pos <= cur_pos[:, None])
    if cfg.sliding_window:
        valid &= pos > (cur_pos[:, None] - cfg.sliding_window)
    s = torch.where(valid[:, None, None, :], s, attn_mod.NEG_INF)
    p = torch.softmax(s, dim=-1)
    if cfg.decode_mxu_einsum:
        p = p.to(v_cache.dtype).float()
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    out = out.reshape(B, 1, H, hd).to(x.dtype)
    y = attn_mod.out_proj(params, out, plan, ctx)
    return y, {"k": k_cache, "v": v_cache, "pos": pos}


def _ring_decode_attn_ro(params, x, cfg, plan, state, cur_pos, ctx=None):
    """Read-only ring-cache decode: attend over the stale cache plus the
    current token's fresh k/v without writing the cache. Returns
    (y, {"k_new", "v_new"}); :func:`stack_apply` writes every layer's new
    kv with one scatter after the last layer."""
    q, k, v = attn_mod.qkv(params, x, cfg, plan,
                           token_positions(cfg, cur_pos))
    k_new, v_new = k[:, 0], v[:, 0]
    dot_layout = cfg.kv_cache_layout == "dot"
    sc = state["pos"].shape[1]
    pos = state["pos"]  # stale: does not hold the current token
    B, _, H, hd = q.shape
    kvp = state["k"].shape[1] if dot_layout else state["k"].shape[2]
    dt = state["k"].dtype
    # the JAX path rounds q to the cache dtype and accumulates in f32
    qg = (q[:, 0].reshape(B, kvp, H // kvp, hd) * hd ** -0.5).to(dt).float()
    kc = state["k"].float()
    if dot_layout:
        s_cache = torch.einsum("bkgh,bkhs->bkgs", qg, kc)
    else:
        s_cache = torch.einsum("bkgh,bskh->bkgs", qg, kc)
    valid = (pos >= 0) & (pos <= cur_pos[:, None]) \
        & (pos > cur_pos[:, None] - sc)
    if cfg.sliding_window:
        valid &= pos > (cur_pos[:, None] - cfg.sliding_window)
    vmask = valid[:, None, None, :]
    s_cache = torch.where(vmask, s_cache, attn_mod.NEG_INF)
    m = s_cache.amax(dim=-1)
    # exp through the mask: an empty cache has m == NEG_INF
    pexp = torch.where(vmask, torch.exp(s_cache - m[..., None]), 0.0)
    l = pexp.sum(dim=-1)
    pv = pexp.to(dt).float()
    if dot_layout:
        acc = torch.einsum("bkgs,bksh->bkgh", pv, state["v"].float())
    else:
        acc = torch.einsum("bkgs,bskh->bkgh", pv, state["v"].float())
    s_cur = torch.einsum("bkgh,bkh->bkg", qg, k_new.to(dt).float())
    out = attn_mod.merge_fresh_token(acc, m, l, s_cur, v_new)
    out = out.reshape(B, 1, H, hd).to(x.dtype)
    y = attn_mod.out_proj(params, out, plan, ctx)
    return y, {"k_new": k_new, "v_new": v_new}


def _ring_prefill_write(state, k, v, cfg, start_pos=0):
    """Write prefill k/v (B,S,kvp,hd) into the ring cache (the last Sc
    positions survive)."""
    B, S = k.shape[0], k.shape[1]
    sc = state["pos"].shape[1]
    n = min(S, sc)
    kw, vw = k[:, -n:], v[:, -n:]
    pos = start_pos + torch.arange(S - n, S, dtype=torch.int32,
                                   device=k.device)
    slots = (pos % sc).long()
    k_cache, v_cache = state["k"].clone(), state["v"].clone()
    if cfg.kv_cache_layout == "dot":
        k_cache[:, :, :, slots] = kw.permute(0, 2, 3, 1)
        v_cache[:, :, slots, :] = vw.permute(0, 2, 1, 3)
    else:
        k_cache[:, slots] = kw
        v_cache[:, slots] = vw
    pos_cache = state["pos"].clone()
    pos_cache[:, slots] = pos.expand(B, n)
    return {"k": k_cache, "v": v_cache, "pos": pos_cache}


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------

def block_apply(params, x, cfg: ModelConfig, plan: HeadPlan,
                ctx: ParallelContext, positions, state: Optional[dict] = None,
                *, chunk: int = 512, gla_chunk: int = 32,
                paged: Optional[PagedAux] = None, emit_kv: bool = False,
                backend: Optional[str] = "auto",
                capacity_tokens: Optional[int] = None,
                with_aux: bool = False, sp: bool = False):
    """One decoder block. Returns (y, new_state), or with ``with_aux``
    (y, new_state, aux): the MoE load-balance loss, f32 zero for the other
    families.

    Under tensor parallelism ``params`` and ``state`` are this rank's
    blocks. ``sp`` (stateless, tensor-parallel): ``x`` and the result are
    this rank's block of the sequence, gathered before attention and the
    MLP and reduce-scattered after them; the norms' replicated scales see
    only that block, so their gradients are summed over the model axis
    (``collectives.model_copy``).

    The mode is inferred: ``state is None`` -> stateless forward;
    seq == 1 with state -> decode; else prefill into the ring state. With
    ``paged`` the decode state is a read-only page-pool slice
    ({"kp","vp"}) walked through the page table. ``emit_kv`` (stateless
    prefill) returns the layer's raw prompt {"k","v"} for direct landing
    in pages. ``backend`` routes the flash prefill kernel
    (``use_pallas_flash``): auto | cuda | ref. An MoE block runs with
    ``no_drop`` when decoding, and sizes its capacity from
    ``capacity_tokens`` when given (``moe.moe_apply``); its aux loss is
    returned only ``with_aux`` (training). The recurrent mixers (ssm, and
    hybrid's Mamba half) run chunked over ``gla_chunk`` tokens.
    """
    check_family(cfg)
    seq = 1 if sp else None  # the sequence dim of a reduce-scatter
    decode = state is not None and x.shape[1] == 1
    ln1, ln2 = params["ln1"], params["ln2"]
    if sp:  # replicated scales applied to this rank's block of the sequence
        ln1, ln2 = ({"scale": coll.model_copy(p["scale"], ctx)}
                    for p in (ln1, ln2))
    h = rmsnorm(ln1, x, cfg.norm_eps)
    if sp:
        h = coll.model_gather(h, ctx, 1)
    S = h.shape[1]
    if cfg.family == "ssm":
        out = _rwkv_block(params, x, h, cfg, state, decode, gla_chunk, ctx)
        return (*out, _zero_aux(x)) if with_aux else out
    new_state = dict(state) if state is not None else None

    if decode:
        cur_pos = _cur_pos(positions)
        if paged is not None:
            att, new_state = _paged_decode_attn_ro(
                params["attn"], h, cfg, plan, state, cur_pos, paged, ctx)
        elif cfg.decode_appended_kv:
            att, new_state = _ring_decode_attn_ro(
                params["attn"], h, cfg, plan, state, cur_pos, ctx)
        else:
            att, att_state = _ring_decode_attn(
                params["attn"], h, cfg, plan, state, cur_pos, ctx)
            new_state.update(att_state)
    else:
        q, k, v = attn_mod.qkv(params["attn"], h, cfg, plan, positions, ctx)
        if cfg.use_pallas_flash and (state is not None or emit_kv) \
                and S % min(cfg.flash_block, S) == 0:
            # the prefill flash kernel (forward only)
            from repro_torch.kernels import ops as kops

            out = kops.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                window=cfg.sliding_window, backend=backend,
            ).transpose(1, 2)
        elif state is None and not emit_kv \
                and S <= attn_mod.TRAIN_FULL_ATTN_MAX:
            out = attn_mod.full_attention(q, k, v, window=cfg.sliding_window)
        else:
            out = attn_mod.chunked_attention(
                q, k, v, window=cfg.sliding_window, chunk=chunk)
        att = attn_mod.out_proj(params["attn"], out, plan, ctx, seq)
        if new_state is not None:
            new_state.update(_ring_prefill_write(state, k, v, cfg))
        elif emit_kv:
            new_state = {"k": k, "v": v}  # raw prompt kv, no staging

    if cfg.family == "hybrid":
        # the Mamba half, averaged with attention: replicated, it runs
        # whole on every rank and joins after out_proj's model-axis sum
        split = state is not None and mamba_state_split(cfg, ctx)
        s_in = None if state is None else state["s"]
        if split:
            s_in = coll.model_gather(s_in, ctx, 1)
        if decode:
            sy, s_new = ssm_mod.mamba_step(params["ssm"], h[:, 0], cfg, s_in)
            sy = sy[:, None]
        else:
            sy, s_new = ssm_mod.mamba_apply(params["ssm"], h, cfg,
                                            state=s_in, chunk=gla_chunk)
        att = (att + sy) * 0.5
        if new_state is not None:
            new_state["s"] = coll.model_block(s_new, ctx, 1).contiguous() \
                if split else s_new

    x = x + att
    h2 = rmsnorm(ln2, x, cfg.norm_eps)
    if sp:
        h2 = coll.model_gather(h2, ctx, 1)
    if cfg.is_moe:
        y2, aux = _moe(params["moe"], h2, cfg, ctx, decode, capacity_tokens)
        if sp:  # the dispatches return the whole sequence on every rank
            y2 = coll.model_block(y2, ctx, 1)
    else:
        y2, aux = mlp_apply(params["mlp"], h2, cfg.act, ctx, seq), None
    if with_aux:
        aux = _zero_aux(x) if aux is None else aux
        return x + y2, new_state, aux
    return x + y2, new_state


def _moe(params, h, cfg, ctx, decode, capacity_tokens):
    """The MoE dispatch the JAX package's block takes: under a mesh with
    ``ep_shardmap``, a stateless or prefill block runs the explicit EP
    (``use_ep``) or expert-TP dispatch; otherwise, and when decoding,
    ``moe_apply`` (GSPMD's path; ``no_drop`` when decoding)."""
    if ctx.ep_shardmap and ctx.mesh is not None and not decode:
        if coll.tensor_parallel(ctx) and (h.shape[0] * h.shape[1]) % ctx.tp:
            raise ValueError(
                f"the shard_map dispatch splits {h.shape[0] * h.shape[1]} "
                f"tokens over {ctx.tp} model ranks")
        fn = moe_mod.moe_apply_ep_shardmap if ctx.use_ep \
            else moe_mod.moe_apply_tp_shardmap
        return fn(params, h, cfg, ctx)
    return moe_mod.moe_apply(params, h, cfg, ctx, no_drop=decode,
                             capacity_tokens=capacity_tokens)


def _zero_aux(x):
    return torch.zeros((), dtype=F32, device=x.device)


def _rwkv_block(params, x, h, cfg, state, decode, gla_chunk, ctx=None):
    """The attention-free RWKV6 block: time mix, then channel mix, each
    token-shifted against the carried last token when decoding. Under
    tensor parallelism the time mix runs the rank's heads (``state["s"]``
    holds them) and the channel mix gathers its column blocks; the
    residual and the token shifts are whole on every rank."""
    y, (tlast, s_new) = ssm_mod.rwkv_tmix_apply(
        params["tmix"], h, cfg,
        prev=state["tshift"] if decode else None,
        state=None if state is None else state["s"], chunk=gla_chunk,
        ctx=ctx)
    x = x + y
    h2 = rmsnorm(params["ln2"], x, cfg.norm_eps)
    y2, clast = ssm_mod.rwkv_cmix_apply(
        params["cmix"], h2, prev=state["cshift"] if decode else None,
        ctx=ctx)
    if state is None:
        return x + y2, None
    return x + y2, {"s": s_new, "tshift": tlast, "cshift": clast}


# ---------------------------------------------------------------------------
# The layer stack
# ---------------------------------------------------------------------------

def stack_init(gen, cfg: ModelConfig, plan: HeadPlan, device):
    """L-stacked block parameters, drawn one layer at a time (so only one
    layer's f32 draws are ever live) into preallocated stacked tensors."""
    first = block_init(gen, cfg, plan, device)
    out = tree_map(lambda t: torch.empty((cfg.num_layers, *t.shape),
                                         dtype=t.dtype, device=t.device),
                   first)
    for i in range(cfg.num_layers):
        lp = first if i == 0 else block_init(gen, cfg, plan, device)
        tree_map(lambda dst, src: dst.copy_(src), layer(out, i), lp)
        del lp
    return out


def unbind(tree):
    """The per-layer views of an L-stacked tree, each leaf unbound once (a
    backward then stacks the per-layer grads, where selecting layer by
    layer would add a whole-stack tensor a layer)."""
    if isinstance(tree, dict):
        per = {k: unbind(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree))


def stack_train(layers, x, cfg: ModelConfig, plan: HeadPlan,
                ctx: ParallelContext, positions, *, chunk: int = 512):
    """The stateless (training) stack: every block in order, each
    rematerialised in the backward when ``cfg.remat`` (the JAX package's
    ``jax.checkpoint`` of the scan body). Returns (y, aux): the MoE aux
    losses summed over the layers in order from f32 zero. With ``ctx.sp``
    under tensor parallelism the blocks run sequence-parallel (``x`` and
    ``y`` whole). Under tensor parallelism it runs the dense and MoE
    families only (:func:`check_tp_train`)."""
    check_tp_train(cfg, ctx)
    sp = _seq_parallel(ctx, x)

    def body(lp, h):
        y, _, a = block_apply(lp, h, cfg, plan, ctx, positions, chunk=chunk,
                              with_aux=True, sp=sp)
        return y, a

    aux = _zero_aux(x)
    h = coll.model_block(x, ctx, 1) if sp else x
    for lp in unbind(layers):
        if cfg.remat:
            h, a = checkpoint(body, lp, h, use_reentrant=False)
        else:
            h, a = body(lp, h)
        aux = aux + a
    return (coll.model_gather(h, ctx, 1) if sp else h), aux


def _seq_parallel(ctx: ParallelContext, x) -> bool:
    """Megatron sequence parallelism for a stateless stack: ``ctx.sp``
    under tensor parallelism (JAX's sharding constraint on each block's
    output, ``P(batch, model, None)``), on a sequence the model axis
    splits evenly."""
    if not (ctx.sp and coll.tensor_parallel(ctx)):
        return False
    if x.shape[1] % ctx.tp:
        raise ValueError(f"sequence parallelism splits {x.shape[1]} "
                         f"positions over {ctx.tp} model ranks")
    return True


def stack_apply(layers, x, cfg: ModelConfig, plan: HeadPlan,
                ctx: ParallelContext, positions, states=None, *,
                chunk: int = 512, paged: Optional[PagedAux] = None,
                emit_kv: bool = False, backend: Optional[str] = "auto",
                capacity_tokens: Optional[int] = None):
    """Apply the blocks in order over the stacked layer params (and
    states when decoding). Returns (y, new_states).

    ``paged`` switches decode to the read-only page-pool path: ``states``
    holds the L-stacked pages {"kp","vp"}, each layer reads its slice, and
    the returned states are only each layer's new {"k_new","v_new"}
    (L, B, kvp, hd) for the caller's one batched append. ``emit_kv``
    (stateless prefill) returns each layer's raw prompt {"k","v"};
    ``capacity_tokens`` goes to every MoE block. With ``ctx.sp`` under
    tensor parallelism a stateless stack runs sequence-parallel between
    its first and last block (``x`` and the result whole)."""
    check_tp(cfg, ctx)
    sp = states is None and _seq_parallel(ctx, x)
    outs = []
    h = coll.model_block(x, ctx, 1) if sp else x
    for i in range(cfg.num_layers):
        st = None if states is None else layer(states, i)
        h, new_st = block_apply(
            layer(layers, i), h, cfg, plan, ctx, positions, st, chunk=chunk,
            paged=paged, emit_kv=emit_kv, backend=backend,
            capacity_tokens=capacity_tokens, sp=sp)
        outs.append(new_st)
    if sp:
        h = coll.model_gather(h, ctx, 1)
    new_states = stack(outs) if outs[0] is not None else None
    decode = states is not None and x.shape[1] == 1
    if decode and paged is None and cfg.decode_appended_kv \
            and cfg.family != "ssm":
        # read-only ring mode: write every layer's new kv with one scatter
        cur = _cur_pos(positions)
        sc = states["pos"].shape[2]
        bidx = torch.arange(cur.shape[0], device=x.device)
        slot = (cur % sc).long()
        merged = {f: states[f].clone() for f in ("k", "v", "pos")}
        if cfg.kv_cache_layout == "dot":
            merged["k"][:, bidx, :, :, slot] = new_states["k_new"].permute(
                1, 0, 2, 3)
            merged["v"][:, bidx, :, slot, :] = new_states["v_new"].permute(
                1, 0, 2, 3)
        else:
            merged["k"][:, bidx, slot] = new_states["k_new"]
            merged["v"][:, bidx, slot] = new_states["v_new"]
        merged["pos"][:, bidx, slot] = cur.to(torch.int32)
        if "s" in new_states:  # hybrid: the new recurrent states
            merged["s"] = new_states["s"]
        new_states = merged
    return h, new_states
