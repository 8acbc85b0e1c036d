"""Mixture-of-Experts block: top-k routing, capacity-based token dropping,
gate-weighted combine.

The JAX package's baseline path (``moe_apply``), which it also takes at
world size 1. Tokens are requests, experts are accelerators and the
capacity buffer is the ring: every (token, expert) assignment gets a slot
in its expert's buffer in token order, and an assignment past the
capacity is dropped. The JAX package's explicit expert-TP and all-to-all
EP variants (``shard_map``) are :func:`moe_apply_tp_shardmap` and
:func:`moe_apply_ep_shardmap`: per-rank functions over the collectives of
``parallel.collectives``, which the stack's ``block_apply`` takes for a
stateless or prefill MoE block under ``ctx.ep_shardmap``, as JAX's does;
otherwise, and for decode, it runs :func:`moe_apply`, tensor-parallel
under a mesh as GSPMD runs it.

What keeps the port equal to JAX:

* the router runs in f32 (never TF32: a rounded router flips top-k
  choices);
* the top k come from a stable descending sort, so ties go to the lower
  expert index as ``jax.lax.top_k``'s do (an all-zero row picks experts
  0..k-1);
* the dispatch positions come from a stable argsort and are exact;
* the expert products return f32 from bf16 operands, as JAX's
  ``preferred_element_type=f32``, with JAX's VJP under autograd
  (:class:`BmmF32`);
* the combine adds each token's k weighted outputs one after another, in
  order j = 0..k-1, from f32 zeros: no atomics, so two runs on the card
  give the same bits.

Under autograd at tp > 1 the dispatches differentiate through the forms
of ``parallel.collectives``: the inputs of rank-local work (the capacity
buffer's tokens, the gates of a partial combine, the EP router) go
through ``model_copy``, the model-axis sums' backward is the identity,
the EP all-to-alls' the reverse all-to-all. Over data ranks the router
statistics' mean (``data_psum``) sums the ranks' cotangents: each data
rank's loss is its own rows', weighted by their share.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    act_fn, dense_init, dtype_of, needs_grad, normal,
)
from repro_torch.parallel import collectives as coll

F32 = torch.float32


def moe_init(gen, cfg: ModelConfig, device):
    """Router ``(D, E)`` in f32; expert weights ``w_gate``/``w_in``
    ``(E, D, F)`` and ``w_out`` ``(E, F, D)`` in the config's dtype, with
    the JAX package's scales. Each expert tensor is drawn in f32 and cast
    before the next is drawn."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = dtype_of(cfg.dtype)
    std = 1.0 / (d ** 0.5)
    return {
        "router": dense_init(gen, d, e, F32, device),
        "w_gate": (normal(gen, (e, d, f), device) * std).to(dt),
        "w_in": (normal(gen, (e, d, f), device) * std).to(dt),
        "w_out": (normal(gen, (e, f, d), device) / (f ** 0.5)).to(dt),
    }


def _route_raw(params, x_flat, cfg: ModelConfig):
    """Returns (gates (T, k) f32, ids (T, k) int64, me (E,), ce (E,)):
    the renormalised top-k gates and the Switch load-balance
    statistics."""
    logits = x_flat.float() @ params["router"]  # (T, E) f32
    k = cfg.num_experts_per_tok
    gate_all = torch.softmax(logits, dim=-1)
    top, order = torch.sort(gate_all, dim=-1, descending=True, stable=True)
    gates, idx = top[:, :k], order[:, :k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    me = gate_all.mean(dim=0)
    ce = F.one_hot(idx, cfg.num_experts).sum(dim=1).float().mean(dim=0) / k
    return gates, idx, me, ce


def _route(params, x_flat, cfg: ModelConfig, ctx=None):
    """(gates, ids, aux loss): the Switch statistics are averaged over
    ``ctx``'s batch axes first (the whole batch's; the identity at one
    data rank), their backward summing the data ranks' cotangents."""
    gates, idx, me, ce = _route_raw(params, x_flat, cfg)
    me, ce = coll.data_pmean(me, ctx), coll.data_pmean(ce, ctx)
    return gates, idx, cfg.num_experts * torch.sum(me * ce)


def _data_offsets(flat_e, num_experts: int, ctx):
    """Each expert's assignments on the earlier data ranks, (E,) int64:
    the offset that turns this rank's positions into the whole batch's
    (rank r holds rows r·B/dp onward, so its tokens follow theirs in
    token order). One gather of an (E,) int32 a data rank."""
    counts = torch.bincount(flat_e, minlength=num_experts).to(torch.int32)
    every = coll.data_gather(counts[None], ctx, 0)  # (dp, E)
    return every[:coll.data_rank(ctx)].sum(0, dtype=torch.int64)


def _capacity(tokens: int, cfg: ModelConfig, experts: int) -> int:
    c = math.ceil(tokens * cfg.num_experts_per_tok / experts
                  * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _dispatch_positions(flat_e, num_experts: int):
    """Slot of each assignment within its expert (stable order), int32."""
    n = flat_e.shape[0]
    dev = flat_e.device
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(
        sorted_e, torch.arange(num_experts, dtype=sorted_e.dtype, device=dev),
        side="left")
    pos_sorted = torch.arange(n, device=dev) - first[sorted_e]
    pos = torch.zeros((n,), dtype=torch.int32, device=dev)
    pos[order] = pos_sorted.to(torch.int32)  # order is a permutation
    return pos


class BmmF32(torch.autograd.Function):
    """``a (E, C, i) @ b (E, i, o)`` in f32 from bf16/f16 operands on the
    card, with the JAX package's VJP (as ``layers.MatmulF32``): the f32
    cotangent times the other operand upcast to f32, cast to the
    operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return BmmF32.grads(a, b, g, ctx.needs_input_grad)

    @staticmethod
    def grads(a, b, g, needs=(True, True)):
        """(grad_a, grad_b) of cotangent ``g`` (None where not needed)."""
        ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype) \
            if needs[0] else None
        gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype) \
            if needs[1] else None
        return ga, gb


def _bmm(a, b):
    """``a (E, C, i) @ b (E, i, o)`` returned in f32."""
    if a.dtype == F32 and b.dtype == F32:
        return torch.bmm(a, b)
    if (a.is_cuda and a.dtype == b.dtype
            and a.dtype in (torch.bfloat16, torch.float16)):
        if needs_grad(a, b):
            return BmmF32.apply(a, b)
        return torch.bmm(a, b, out_dtype=F32)
    return torch.bmm(a.float(), b.float())


def _expert_ffn(w_gate, w_in, w_out, buf, act: str, ctx=None):
    """buf: (E, C, D) -> (E, C, D), every expert's gated MLP at once;
    with ``ctx`` the weights are ``d_ff`` blocks and ``w_out``'s f32
    partials are summed over the model axis before the cast."""
    g = _bmm(buf, w_gate)
    h = _bmm(buf, w_in)
    y = (act_fn(act)(g) * h).to(buf.dtype)
    return coll.model_psum(_bmm(y, w_out), ctx).to(buf.dtype)


def moe_apply(params, x, cfg: ModelConfig, ctx=None, *,
              no_drop: bool = False, capacity_tokens: Optional[int] = None):
    """x: (..., D) -> ((..., D), aux loss): the JAX package's GSPMD path.

    ``no_drop`` (decode): capacity = T, so no assignment is dropped.
    ``capacity_tokens`` sizes the capacity from that token count instead
    of T: the paged engine prefills only the admitted prefix of its
    admission batch, and passes the padded batch's count so every
    admitted assignment keeps the slot, and the keep, that the whole
    padded batch would give it (the prefix comes first in token order and
    the dispatch sort is stable).

    Under tensor parallelism (``ctx``'s model axis over more than one
    rank; ``x`` whole on every model rank) every rank routes and
    dispatches all of ``x``'s tokens, as GSPMD does with the router
    replicated. With ``ctx.use_ep`` the rank holds its ``E / tp`` experts
    (``P(model, ...)``), runs them on their buffers and combines their
    assignments in order, and a sum over the model axis adds the ranks'
    partial combines; else it holds every expert's ``d_ff`` block
    (``P(None, ..., model)``), whose f32 partial products meet in a sum
    over the model axis before the cast and the combine.

    Over data ranks (``ctx``'s batch axes over more than one rank; ``x``
    this rank's rows) the capacity, the dispatch positions and the
    router statistics are the whole batch's, as GSPMD's: the capacity
    from the data ranks' tokens summed (``capacity_tokens`` is read as
    the global padded batch's count), each assignment's position its
    position on this rank plus the assignments to its expert on the
    earlier data ranks (one gather of the ranks' (E,) counts), kept where
    that is under the capacity. Each rank then runs only its own kept
    assignments, in a buffer of its own: the expert MLP works on each
    row alone, so no activation crosses ranks. ``no_drop`` keeps every
    assignment and needs no offset."""
    shape = x.shape
    d = shape[-1]
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    e = cfg.num_experts
    tp = coll.tensor_parallel(ctx)
    dp = coll.data_parallel(ctx)

    gates, idx, aux = _route(params, x_flat, cfg, ctx)
    offset = None
    if no_drop:
        cap = t
    else:
        cap = _capacity(capacity_tokens or t * (ctx.dp if dp else 1), cfg,
                        e)
        if dp:
            offset = _data_offsets(idx.reshape(-1), e, ctx)
    # the rank-local work's inputs: their gradients summed over the model
    # axis (the identity without tensor parallelism)
    x_loc = coll.model_copy(x_flat, ctx)
    if tp and ctx.use_ep:  # this rank's experts; the partial combines summed
        e_loc = params["w_gate"].shape[0]
        first = coll.model_rank(ctx) * e_loc
        y = coll.model_psum(_experts_local(
            params, x_loc, coll.model_copy(gates, ctx), idx, cap, cfg,
            experts=(first, first + e_loc), offset=offset), ctx)
    else:  # all experts, or every expert's d_ff block summed in the FFN
        y = _experts_local(params, x_loc, gates, idx, cap, cfg, ctx=ctx,
                           offset=offset)
    return y.to(x.dtype).reshape(shape), aux


def _combine(picked, gates, t: int, k: int):
    """Each token's k gate-weighted outputs added in order, from f32
    zeros (no atomics)."""
    weighted = (picked.float() * gates.reshape(-1)[:, None]).reshape(
        t, k, -1)
    y = torch.zeros((t, weighted.shape[-1]), dtype=F32,
                    device=picked.device)
    for j in range(k):
        y = y + weighted[:, j]
    return y


def _experts_local(params, x_flat, gates, idx, cap: int, cfg: ModelConfig,
                   experts=None, ctx=None, offset=None):
    """Dispatch ``x_flat``'s assignments to every expert's capacity buffer
    (slots in token order, past ``cap`` dropped), run the experts held in
    ``params``, and combine: (T, D) f32.

    ``offset`` (E,): the assignments to each expert ahead of these tokens
    on other ranks. An assignment is kept where its slot plus its
    expert's offset is under ``cap`` (the whole batch's keep), and takes
    its slot in this rank's buffer (under ``cap`` too).

    ``experts=(lo, hi)``: ``params`` hold experts lo..hi-1 only, so only
    their buffers are built and run, and the combine takes only their
    assignments (the others add zeros). ``ctx``: ``params`` hold every
    expert's ``d_ff`` block, and the f32 output of ``w_out`` is summed
    over the model axis before the cast to the dtype."""
    t, d = x_flat.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    lo, hi = experts or (0, e)
    n = hi - lo
    dev = x_flat.device
    flat_e = idx.reshape(-1)  # (T*k,)
    pos = _dispatch_positions(flat_e, e)
    glob = pos if offset is None else pos + offset[flat_e]
    keep = (glob < cap) & (flat_e >= lo) & (flat_e < hi)
    # the dropped (and other ranks') assignments land on the spare row
    # n*cap, sliced off
    dest = torch.where(keep, (flat_e - lo) * cap + pos, n * cap)
    src_token = torch.arange(t, device=dev).repeat_interleave(k)

    buf = torch.zeros((n * cap + 1, d), dtype=x_flat.dtype, device=dev)
    buf[dest] = x_flat[src_token]
    out_buf = _expert_ffn(params["w_gate"], params["w_in"], params["w_out"],
                          buf[: n * cap].reshape(n, cap, d), cfg.act, ctx)

    flat_out = out_buf.reshape(n * cap, d)
    picked = torch.where(keep[:, None],
                         flat_out[torch.clamp(dest, max=n * cap - 1)], 0.0)
    return _combine(picked, gates, t, k)


# ---------------------------------------------------------------------------
# The JAX package's shard_map dispatches, per rank
# ---------------------------------------------------------------------------

def moe_apply_tp_shardmap(params, x, cfg: ModelConfig, ctx):
    """Expert-TP dispatch on one rank of ``ctx.mesh`` (not EP): every
    (batch, model) rank dispatches its OWN tokens into its OWN capacity
    buffer (no collective), runs its d_ff block of every expert, and the
    partial sums meet in one ``psum`` over the model axis — the all-reduce
    a dense TP MLP pays.

    ``params``: ``router`` (D, E) whole; ``w_gate``/``w_in`` (E, D, F/tp)
    and ``w_out`` (E, F/tp, D), this rank's d_ff block (the JAX package's
    in_specs ``P(None, None, m)``, ``P(None, m, None)``). ``x``: (B_loc,
    S, D), this rank's rows (batch over the batch axes, replicated over
    model). Returns (y (B_loc, S, D), aux): the aux loss from router
    statistics averaged over the batch axes."""
    mesh = ctx.mesh
    assert mesh is not None and not ctx.use_ep
    b_loc, s, d = x.shape
    t = b_loc * s
    xf = x.reshape(t, d)
    gates, idx, me, ce = _route_raw(params, xf, cfg)
    aux = cfg.num_experts * torch.sum(coll.data_pmean(me, ctx)
                                      * coll.data_pmean(ce, ctx))
    cap = _capacity(t, cfg, cfg.num_experts)
    # the d_ff blocks' work is rank-local: its inputs' gradients are
    # summed over the model axis, the psum's backward is the identity
    y = _experts_local(params, coll.model_copy(xf, ctx),
                       coll.model_copy(gates, ctx), idx, cap, cfg)
    y = coll.psum(y, mesh, ctx.model_axis)  # the d_ff partial sums
    return y.to(x.dtype).reshape(b_loc, s, d), aux


def moe_apply_ep_shardmap(params, x, cfg: ModelConfig, ctx):
    """Expert-parallel dispatch on one rank of ``ctx.mesh``: two
    all-to-alls over the model axis move only capacity buffers
    (tokens-as-requests), never whole activations.

    ``params``: ``router`` whole; ``w_gate``, ``w_in``, ``w_out`` this
    rank's E/tp experts (in_specs ``P(m, None, None)``). ``x``: (B_loc, S,
    D), this rank's rows, equal on every model rank; each model rank
    routes its 1/tp of them. Returns (y (B_loc, S, D), aux), y gathered
    back over the model axis; aux from the router statistics averaged
    over the model and batch axes (the exact global aux loss)."""
    mesh = ctx.mesh
    assert mesh is not None and ctx.use_ep
    tp, m = ctx.tp, ctx.model_axis
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    e_loc = e // tp
    b_loc, s, d = x.shape
    t_loc = b_loc * s
    t_m = t_loc // tp
    dev = x.device
    # this rank's tokens (backward: the ranks' gradient blocks gathered);
    # the router sees only them, so its gradient is summed over the axis
    xm = coll.model_block(x.reshape(t_loc, d), ctx, 0)
    router = {"router": coll.model_copy(params["router"], ctx)}

    gates, idx, me, ce = _route_raw(router, xm, cfg)
    # over the model axis a sum of statistics every rank's loss holds
    # (identity backward), over the data axes one of the ranks' own
    me, ce = (coll.data_psum(coll.psum(v, mesh, m), ctx) / (tp * ctx.dp)
              for v in (me, ce))
    aux = e * torch.sum(me * ce)
    flat_e = idx.reshape(-1)
    dest_rank = flat_e // e_loc
    cap_s = _capacity(t_m, cfg, tp)  # per-destination-rank send capacity
    pos = _dispatch_positions(dest_rank, tp)
    keep = pos < cap_s
    dest = torch.where(keep, dest_rank * cap_s + pos, tp * cap_s)
    src = torch.arange(t_m, device=dev).repeat_interleave(k)

    send = torch.zeros((tp * cap_s + 1, d), dtype=x.dtype, device=dev)
    send[dest] = xm[src]
    meta = torch.full((tp * cap_s + 1,), -1, dtype=torch.int32, device=dev)
    meta[dest] = (flat_e % e_loc).to(torch.int32)
    recv = coll.all_to_all(send[: tp * cap_s].reshape(tp, cap_s, d), mesh,
                           m).reshape(tp * cap_s, d)
    rmeta = coll.all_to_all(meta[: tp * cap_s].reshape(tp, cap_s), mesh,
                            m).reshape(tp * cap_s)

    # local second-level dispatch to the e_loc experts (-1 rows: none;
    # their positions come from a spare bucket e_loc and are masked)
    cap2 = _capacity(tp * cap_s, cfg.replace(num_experts_per_tok=1), e_loc)
    lpos = _dispatch_positions(torch.where(rmeta >= 0, rmeta, e_loc),
                               e_loc + 1)
    lkeep = (lpos < cap2) & (rmeta >= 0)
    ldest = torch.where(lkeep, rmeta * cap2 + lpos, e_loc * cap2)
    buf = torch.zeros((e_loc * cap2 + 1, d), dtype=x.dtype, device=dev)
    buf[ldest] = recv
    buf = buf[: e_loc * cap2].reshape(e_loc, cap2, d)

    out = _expert_ffn(params["w_gate"], params["w_in"], params["w_out"], buf,
                      cfg.act).reshape(-1, d)
    back = torch.where(lkeep[:, None],
                       out[torch.clamp(ldest, max=e_loc * cap2 - 1)], 0.0)
    ret = coll.all_to_all(back.reshape(tp, cap_s, d), mesh,
                          m).reshape(tp * cap_s, d)
    picked = torch.where(keep[:, None],
                         ret[torch.clamp(dest, max=tp * cap_s - 1)], 0.0)
    ym = _combine(picked, gates, t_m, k)
    y = coll.all_gather(ym.to(x.dtype), mesh, m, 0)  # re-replicate
    return y.reshape(b_loc, s, d), aux
