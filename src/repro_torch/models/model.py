"""Top-level LM: init, the training forward and loss, prefill and decode
(dense per-slot ring caches, or the shared page pool), for all six
families. The vlm family's M-RoPE positions are the text stub
(t = h = w) and its media embeddings are added at the first positions
of a prefill or a training forward; the audio family takes
(B, S, K) codebook frames and returns (B, K, V) logits a step. The
recurrent families (ssm, hybrid) decode on the dense path only.

Under a running mesh (``launch.mesh``) every function here is per rank,
as JAX's GSPMD step is per device: ``params`` are this rank's blocks
(``sharding.param_blocks``), tokens and states its rows of the batch
(split over the data axes when they divide it, ``batch_specs``), and the
decode state holds its kv heads (:func:`decode_state_specs`). Megatron
tensor parallelism over the model axis runs every family's forward,
prefill and ring-cache decode (training: the dense and MoE families;
the others' forward under no gradient is the serving stack): the
embedding and the head are vocab-parallel, and the logits returned are
whole (the vocab shards gathered), so a greedy token is the whole row's
argmax and its ties go to the lowest global index, as on one device.
:func:`loss_fn` takes a vocab-parallel log-sum-exp and gold logit, and
its gradient comes back through the model-axis forms' backward
(``parallel.collectives``); :func:`postprocess_grads` ties the kv
replicas across the model ranks. The paged path runs on both axes: each
rank's pool holds its kv heads (:func:`make_paged_kv_config`); over data
ranks the allocator, page table and lengths are the whole batch's on
every rank, and each rank decodes its rows (:func:`batch_rows`), walking
and writing only its slots' pages (:func:`paged_decode_step`)."""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tf
from repro_torch.models.attention import tie_kv_grads
from repro_torch.models.layers import (
    dtype_of, embed_apply, embed_init, lm_head_apply, lm_head_init, rmsnorm,
    rmsnorm_init,
)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import P, ParallelContext, shard

I32 = torch.int32


class DecodeState(NamedTuple):
    layers: Any  # L-stacked per-layer states (tf.layer_state_zeros)
    pos: torch.Tensor  # (B,) tokens already in context (next write pos)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(seed: int, cfg: ModelConfig, ctx: ParallelContext,
                device="cuda"):
    """Random parameters from ``seed`` (a ``torch.Generator`` on
    ``device``), with the JAX package's shapes, layout and distributions:
    ``{"embed": {"tok"}, "layers": {L-stacked block params},
    "final_norm": {"scale"}[, "lm_head": {"w"}]}``. The draws differ from
    JAX's; tests carry JAX's params across with
    ``interop.lm_params_from_numpy``. On the ``meta`` device nothing is
    drawn or allocated (:func:`abstract_params`)."""
    tf.check_family(cfg)
    device = torch.device(device)
    # a generator feeds no meta sampler: meta draws take none
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    plan = tf.plan_for(cfg, ctx)
    params = {
        "embed": embed_init(gen, cfg, device),
        "layers": tf.stack_init(gen, cfg, plan, device),
        "final_norm": rmsnorm_init(cfg.d_model, dtype_of(cfg.dtype), device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = lm_head_init(gen, cfg, device)
    return params


def abstract_params(cfg: ModelConfig, ctx: ParallelContext):
    """The params' skeleton: meta tensors of their shapes and dtypes, at
    the context's tensor-parallel head padding. Nothing is allocated."""
    return init_params(0, cfg, ctx, device="meta")


def _positions_for(cfg: ModelConfig, tokens):
    """(B, S) positions of a prompt (tokens (B, S) or (B, S, K)); M-RoPE
    takes them as (3, B, S), the text stub's t = h = w."""
    b, s = tokens.shape[:2]
    pos = torch.arange(s, dtype=I32, device=tokens.device)[None].expand(b, s)
    return pos.expand(3, b, s) if cfg.mrope else pos


def _step_input(params, tokens, cfg, ctx):
    """One decoding token a sequence, (B,) or codebooks (B, K), embedded
    as (B, 1, D)."""
    tok = tokens[:, None] if tokens.dim() == 1 else tokens[:, None, :]
    return shard(embed_apply(params["embed"], tok, cfg, ctx), ctx)


def _head_local(params, h, cfg, ctx):
    """The final norm and the head: f32 logits, this rank's vocab columns
    under tensor parallelism."""
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return lm_head_apply(params.get("lm_head"), h, cfg,
                         embed_params=params["embed"], ctx=ctx)


def _head(params, h, cfg, ctx):
    """Whole-vocab f32 logits (the vocab shards gathered)."""
    return coll.model_gather(_head_local(params, h, cfg, ctx), ctx, -1)


def _embed(params, tokens, cfg, media, ctx=None):
    """Token (or codebook) embeddings, with a vlm's ``media`` (B, M, D)
    added at the first M positions."""
    h = embed_apply(params["embed"], tokens, cfg, ctx)
    if cfg.media_tokens and media is not None:
        m = media.shape[1]
        h = torch.cat([h[:, :m] + media.to(h.dtype), h[:, m:]], dim=1)
    return h


# ---------------------------------------------------------------------------
# Training: forward, loss, gradient post-processing
# ---------------------------------------------------------------------------

def forward(params, tokens, cfg: ModelConfig, ctx: ParallelContext, *,
            media=None, chunk: int = 512):
    """The stateless forward over tokens (B, S) or codebook frames
    (B, S, K). Returns (f32 logits (B, S, V) or (B, S, K, V), the MoE aux
    loss summed over the layers)."""
    logits, aux = _forward_local(params, tokens, cfg, ctx, media, chunk)
    return coll.model_gather(logits, ctx, -1), aux


def _forward_local(params, tokens, cfg, ctx, media, chunk):
    """:func:`forward` with this rank's vocab columns of the logits. A
    family that trains on one device only (``tf.check_tp_train``) runs
    its tensor-parallel forward under no gradient through the serving
    stack (the same blocks, stateless)."""
    plan = tf.plan_for(cfg, ctx)
    h = shard(_embed(params, tokens, cfg, media, ctx), ctx)
    positions = _positions_for(cfg, tokens)
    if coll.tensor_parallel(ctx) and cfg.family not in tf.TP_TRAIN_FAMILIES \
            and not torch.is_grad_enabled():
        h, _ = tf.stack_apply(params["layers"], h, cfg, plan, ctx, positions,
                              chunk=chunk)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    else:
        h, aux = tf.stack_train(params["layers"], h, cfg, plan, ctx,
                                positions, chunk=chunk)
    return _head_local(params, h, cfg, ctx), aux


def loss_fn(params, batch, cfg: ModelConfig, ctx: ParallelContext, *,
            chunk: int = 512):
    """batch: {"tokens", "labels"[, "media"]} -> (loss, {"ce", "aux"}):
    the mean next-token cross entropy plus 0.01 x the aux loss. The gold
    logit is a gather, which is the JAX package's one-hot sum (it adds
    only zeros to the one value) without a (B, S, V) mask. Under a mesh
    the mean is over this rank's rows (a caller over data ranks averages
    them, as ZeRO-1 does); under tensor parallelism the log-sum-exp and
    the gold logit are vocab-parallel (a max and two sums over the model
    axis), and the logits are never gathered."""
    logits, aux = _forward_local(params, batch["tokens"], cfg, ctx,
                                 batch.get("media"), chunk)
    labels = batch["labels"].long()
    if not coll.tensor_parallel(ctx):
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    else:
        v_loc = logits.shape[-1]
        m = coll.pmax(logits.amax(dim=-1), ctx.mesh, ctx.model_axis)
        lse = m + torch.log(coll.model_psum(
            torch.exp(logits - m[..., None]).sum(dim=-1), ctx))
        ids = labels - coll.model_rank(ctx) * v_loc
        inside = (ids >= 0) & (ids < v_loc)
        mine = torch.gather(logits, -1,
                            ids.clamp(0, v_loc - 1)[..., None])[..., 0]
        gold = coll.model_psum(torch.where(inside, mine, 0.0), ctx)
    ce = torch.mean(lse - gold)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def postprocess_grads(grads, cfg: ModelConfig, ctx: ParallelContext):
    """Re-tie the kv-replica gradients (``attention.tie_kv_grads``) so
    replicated physical kv heads stay equal; the identity at world size
    1. Under tensor parallelism ``grads`` are this rank's blocks and a
    replication group spans model ranks (tied across them)."""
    plan = tf.plan_for(cfg, ctx)
    if cfg.attn_free or plan.repl == 1:
        return grads
    layers = dict(grads["layers"])
    if "attn" in layers:
        layers["attn"] = tie_kv_grads(layers["attn"], plan, ctx)
    return {**grads, "layers": layers}


# ---------------------------------------------------------------------------
# Serving: prefill + dense decode
# ---------------------------------------------------------------------------

def make_decode_state(cfg: ModelConfig, ctx: ParallelContext, batch: int,
                      cache_len: int, device="cuda") -> DecodeState:
    """Zero decode state for a global ``batch``. Under a mesh it is this
    rank's block (:func:`decode_state_specs`): its rows when the data
    axes divide the batch (:func:`batch_rows`), and its kv heads (and
    recurrent state heads, where the spec splits them) under tensor
    parallelism."""
    tf.check_tp(cfg, ctx)
    plan = tf.plan_for(cfg, ctx)
    if _batch_axis_or_none(batch, ctx) is not None:
        batch //= ctx.dp
    layers = tf.stack([tf.layer_state_zeros(cfg, plan, batch, cache_len,
                                            device, ctx)
                       for _ in range(cfg.num_layers)])
    return DecodeState(layers, torch.zeros((batch,), dtype=I32,
                                           device=device))


def prefill(params, tokens, state: DecodeState, cfg: ModelConfig,
            ctx: ParallelContext, *, media=None, chunk: int = 512,
            backend="auto", all_logits: bool = False):
    """Fill the decode state from a prompt (B, S), or codebook frames
    (B, S, K). ``media`` (B, M, D), for a vlm config, is added to the
    embeddings of the first M positions. Returns (new_state, last_logits
    (B, V), or (B, K, V), f32); with ``all_logits`` the logits of every
    position, (B, S, V) or (B, S, K, V): the teacher-forced rows."""
    plan = tf.plan_for(cfg, ctx)
    h = shard(_embed(params, tokens, cfg, media, ctx), ctx)
    h, new_layers = tf.stack_apply(
        params["layers"], h, cfg, plan, ctx, _positions_for(cfg, tokens),
        states=state.layers, chunk=chunk, backend=backend)
    new_state = DecodeState(new_layers, state.pos + tokens.shape[1])
    if all_logits:
        return new_state, _head(params, h, cfg, ctx)
    return new_state, _head(params, h[:, -1:], cfg, ctx)[:, 0]


def decode_step(params, tokens, state: DecodeState, cfg: ModelConfig,
                ctx: ParallelContext):
    """One token per sequence. tokens: (B,) or codebooks (B, K). Returns
    (new_state, logits (B, V) or (B, K, V))."""
    plan = tf.plan_for(cfg, ctx)
    h = _step_input(params, tokens, cfg, ctx)
    cur = state.pos
    h, new_layers = tf.stack_apply(
        params["layers"], h, cfg, plan, ctx,
        tf.token_positions(cfg, cur.to(I32)), states=state.layers)
    return DecodeState(new_layers, cur + 1), _head(params, h, cfg, ctx)[:, 0]


# ---------------------------------------------------------------------------
# Serving: paged decode (the shared page pool)
# ---------------------------------------------------------------------------

def check_paged_support(cfg: ModelConfig, ctx=None) -> None:
    """The paged path stores pages in bshd layout and walks full causal
    context; families with recurrent state, and windowed or dot-layout
    caches, keep the dense decode path."""
    tf.check_family(cfg)
    if cfg.attn_free or cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"paged decode needs a pure-attention family, got {cfg.family}")
    if cfg.kv_cache_layout != "bshd":
        raise NotImplementedError("paged decode stores pages in bshd layout")
    if cfg.sliding_window:
        raise NotImplementedError("paged decode does not window the page walk")


def make_paged_kv_config(cfg: ModelConfig, ctx: ParallelContext, *,
                         num_pages: int, page_size: int,
                         max_pages_per_seq: int):
    """A PagedKVConfig matching this model's physical kv geometry: under
    tensor parallelism this rank's ``plan.kv_phys / tp`` kv heads (one
    replica a rank where the plan replicates kv, as the dense rings)."""
    from repro_torch.serving.kv_cache import PagedKVConfig

    check_paged_support(cfg, ctx)
    plan = tf.plan_for(cfg, ctx)
    return PagedKVConfig(
        num_pages=num_pages, page_size=page_size,
        max_pages_per_seq=max_pages_per_seq,
        kv_heads=plan.kv_phys // (ctx.tp if coll.tensor_parallel(ctx)
                                  else 1),
        head_dim=cfg.resolved_head_dim, layers=cfg.num_layers,
    )


def paged_decode_step(params, tokens, kv, pcfg, cfg: ModelConfig,
                      ctx: ParallelContext, *, active=None,
                      kernel_backend: Optional[str] = "auto"):
    """One token per active sequence against the shared page pool.

    tokens: (B,); kv: ``kv_cache.PagedKVState`` over the slots; active:
    (B,) bool (inactive slots neither append nor advance; their logits are
    garbage the caller masks). COLD slots are masked out of ``active``.
    Every layer attends READ-ONLY over the stale pool (the
    ``paged_attention_stats`` walk per ``kernel_backend``) and LSE-merges
    the current token's fresh k/v; after the last layer ONE
    ``append_token_batch`` commits every layer's new kv, in place. Returns
    (kv', logits (b, V), ok (B,)): ok False where the pool was dry (the
    slot stalls: nothing appended). Under tensor parallelism ``kv`` is
    this rank's pool (its kv heads), the walk attends its q heads, and
    the logits are whole, so every rank takes the same pool decisions.

    Over data ranks ``tokens``, ``active`` and the pool's allocator, page
    table, lengths and residency are the whole batch's on every rank, so
    every rank takes every slot's allocation; the rank decodes only its
    rows (:func:`batch_rows`: b = B / dp when the data axes divide B,
    else all B, every rank the same): it walks and writes only its
    slots' pages, and returns its rows' logits."""
    from repro_torch.serving import kv_cache as pk

    check_paged_support(cfg, ctx)
    plan = tf.plan_for(cfg, ctx)
    b = tokens.shape[0]
    rows = batch_rows(b, ctx)
    rctx = rows_context(b, ctx)
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=tokens.device)
    active = active & (kv.residency == pk.HOT)
    kv, ok = pk.ensure_capacity_batch(kv, pcfg, active)
    eff = active & ok
    cur = kv.lengths[rows]  # stale length = position of the new token
    aux = tf.PagedAux(page_table=kv.page_table[rows], lengths=cur,
                      backend=kernel_backend)
    h = _step_input(params, tokens[rows], cfg, rctx)
    h, new_states = tf.stack_apply(
        params["layers"], h, cfg, plan, rctx,
        tf.token_positions(cfg, cur.to(I32)),
        states={"kp": kv.k_pages, "vp": kv.v_pages}, paged=aux)
    logits = _head(params, h, cfg, rctx)
    kv = pk.append_token_batch(kv, pcfg, new_states["k_new"],
                               new_states["v_new"], eff, rows=rows)
    return kv, logits[:, 0], ok


def prefill_kv(params, tokens, cfg: ModelConfig, ctx: ParallelContext, *,
               chunk: int = 512, kernel_backend: Optional[str] = "auto",
               capacity_tokens: Optional[int] = None):
    """Direct paged prefill: the prompt kv comes straight off the layers
    (``stack_apply(emit_kv=True)``), never staged in a dense cache.
    Returns (k (L, B, S, kvp, hd), v, last_logits (B, V)); the engine
    writes k/v into the pool (``kv_cache.prefill_into_pages``).
    ``capacity_tokens`` sizes the MoE capacity from that token count in
    place of B x S (the engine passes its padded admission batch's; over
    data ranks, the global batch's). Under a mesh ``tokens`` are this
    rank's rows and k/v hold its kv heads (the engine over data ranks
    passes every rank the whole batch under :func:`whole_batch`)."""
    check_paged_support(cfg)
    plan = tf.plan_for(cfg, ctx)
    h = shard(embed_apply(params["embed"], tokens, cfg, ctx), ctx)
    h, kvs = tf.stack_apply(
        params["layers"], h, cfg, plan, ctx, _positions_for(cfg, tokens),
        chunk=chunk, emit_kv=True, backend=kernel_backend,
        capacity_tokens=capacity_tokens)
    return kvs["k"], kvs["v"], _head(params, h[:, -1:], cfg, ctx)[:, 0]


# ---------------------------------------------------------------------------
# PartitionSpecs for serving state and batches; abstract inputs
# ---------------------------------------------------------------------------

def _batch_axis_or_none(cfg_batch: int, ctx: ParallelContext):
    """Shard batch over the data axes only when it divides evenly."""
    if ctx.mesh is None:
        return None
    if cfg_batch % ctx.dp != 0:
        return None
    axes = ctx.batch_axes
    return axes[0] if len(axes) == 1 else axes


def batch_rows(batch: int, ctx: ParallelContext) -> slice:
    """This rank's rows of a global batch of ``batch`` rows: its block
    (in ``collectives.data_rank`` order) when the data axes split the
    batch (:func:`decode_state_specs`), else all of them (replicated
    over the data ranks, as ``_batch_axis_or_none`` leaves a batch they
    do not divide)."""
    if not coll.data_parallel(ctx) or _batch_axis_or_none(batch, ctx) is None:
        return slice(0, batch)
    n = batch // ctx.dp
    r = coll.data_rank(ctx)
    return slice(r * n, (r + 1) * n)


def whole_batch(ctx: ParallelContext) -> ParallelContext:
    """The context of work every data rank does on the whole batch: the
    model axis kept, no batch axes (so an MoE block's capacity and
    dispatch are the whole batch's, with no collective over the data
    axes)."""
    if not coll.data_parallel(ctx):
        return ctx
    return ctx._replace(data_axes=(), pod_axis=None)


def rows_context(batch: int, ctx: ParallelContext) -> ParallelContext:
    """The context of a rank's :func:`batch_rows`: ``ctx`` when the data
    axes split the batch, else :func:`whole_batch`."""
    return ctx if batch_rows(batch, ctx) != slice(0, batch) \
        else whole_batch(ctx)


def decode_state_specs(cfg: ModelConfig, ctx: ParallelContext, batch: int):
    """PartitionSpec tree mirroring ``make_decode_state``'s structure."""
    bs = _batch_axis_or_none(batch, ctx)
    m = ctx.model_axis if ctx.mesh is not None else None
    tp = max(ctx.tp, 1)
    layer: dict = {}
    if cfg.family == "ssm":
        h = cfg.d_model // (cfg.resolved_head_dim or 64)
        layer["s"] = P(None, bs, m if h % tp == 0 else None, None, None)
        layer["tshift"] = P(None, bs, None)
        layer["cshift"] = P(None, bs, None)
    elif cfg.kv_cache_layout == "dot":
        layer["k"] = P(None, bs, m, None, None)
        layer["v"] = P(None, bs, m, None, None)
        layer["pos"] = P(None, bs, None)
    else:
        layer["k"] = P(None, bs, None, m, None)
        layer["v"] = P(None, bs, None, m, None)
        layer["pos"] = P(None, bs, None)
        if cfg.family == "hybrid":
            hm = (cfg.d_model * cfg.ssm_expand) // 64
            layer["s"] = P(None, bs, m if hm % tp == 0 else None, None, None)
    return DecodeState(layers=layer, pos=P(bs))


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, ctx: ParallelContext):
    """PartitionSpecs matching ``input_specs(cfg, shape)``."""
    bs = _batch_axis_or_none(shape.global_batch, ctx)
    if shape.kind in ("train", "prefill"):
        tok = P(bs, None, None) if cfg.num_codebooks else P(bs, None)
        out = {"tokens": tok}
        if shape.kind == "train":
            out["labels"] = tok
        if cfg.media_tokens:
            out["media"] = P(bs, None, None)
        return out
    tok = P(bs, None) if cfg.num_codebooks else P(bs)
    return {"tokens": tok}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins (shape and dtype, no storage) for every model
    input of a shape: the JAX package's ``ShapeDtypeStruct``s."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dt=I32):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        toks = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
        spec = {"tokens": meta(toks)}
        if shape.kind == "train":
            spec["labels"] = meta(toks)
        if cfg.media_tokens:
            spec["media"] = meta((b, cfg.media_tokens, cfg.d_model),
                                 torch.bfloat16)
        return spec
    # decode: one new token per sequence, cache of length s
    toks = (b, cfg.num_codebooks) if cfg.num_codebooks else (b,)
    return {"tokens": meta(toks)}
