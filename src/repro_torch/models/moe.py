"""Mixture-of-Experts block: top-k routing, capacity-based token dropping,
gate-weighted combine.

The JAX package's baseline path (``moe_apply``), which it also takes at
world size 1. Tokens are requests, experts are accelerators and the
capacity buffer is the ring: every (token, expert) assignment gets a slot
in its expert's buffer in token order, and an assignment past the
capacity is dropped. The JAX package's explicit all-to-all and expert-TP
variants (``shard_map``) are not ported.

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


def _route(params, x_flat, cfg: ModelConfig):
    gates, idx, me, ce = _route_raw(params, x_flat, cfg)
    return gates, idx, cfg.num_experts * torch.sum(me * ce)


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


def _expert_ffn(w_gate, w_in, w_out, buf, act: str):
    """buf: (E, C, D) -> (E, C, D), every expert's gated MLP at once."""
    g = _bmm(buf, w_gate)
    h = _bmm(buf, w_in)
    y = (act_fn(act)(g) * h).to(buf.dtype)
    return _bmm(y, w_out).to(buf.dtype)


def moe_apply(params, x, cfg: ModelConfig, *, no_drop: bool = False,
              capacity_tokens: Optional[int] = None):
    """x: (..., D) -> ((..., D), aux loss), at world size 1.

    ``no_drop`` (decode): capacity = T, so no assignment is dropped.
    ``capacity_tokens`` sizes the capacity from that token count instead
    of T: the paged engine prefills only the admitted prefix of its
    admission batch, and passes the padded batch's count so every
    admitted assignment keeps the slot, and the keep, that the whole
    padded batch would give it (the prefix comes first in token order and
    the dispatch sort is stable)."""
    shape = x.shape
    d = shape[-1]
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dev = x.device

    gates, idx, aux = _route(params, x_flat, cfg)
    cap = t if no_drop else _capacity(capacity_tokens or t, cfg, e)

    flat_e = idx.reshape(-1)  # (T*k,)
    pos = _dispatch_positions(flat_e, e)
    keep = pos < cap
    dest = torch.where(keep, flat_e * cap + pos, e * cap)  # e*cap = dropped
    src_token = torch.arange(t, device=dev).repeat_interleave(k)

    # the dropped assignments land on the spare row e*cap, sliced off
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf[dest] = x_flat[src_token]
    out_buf = _expert_ffn(params["w_gate"], params["w_in"], params["w_out"],
                          buf[: e * cap].reshape(e, cap, d), cfg.act)

    flat_out = out_buf.reshape(e * cap, d)
    picked = torch.where(keep[:, None],
                         flat_out[torch.clamp(dest, max=e * cap - 1)], 0.0)
    weighted = (picked.float() * gates.reshape(-1)[:, None]).reshape(t, k, d)
    y = torch.zeros((t, d), dtype=F32, device=dev)
    for j in range(k):  # in order, no atomics
        y = y + weighted[:, j]
    return y.to(x.dtype).reshape(shape), aux
