"""Shared layers: norms, MLPs, rotary embeddings, token/codebook embeddings.

Functional, as in the JAX package: ``*_init(gen, ...) -> params`` and
``*_apply(params, x, ...) -> y``. Parameters are plain dicts of tensors.
Matmuls return f32 whatever the storage dtype, as JAX's
``preferred_element_type=f32`` does: a bf16 product rounded to bf16 would
change every later layer. Under autograd, a bf16 product on the card goes
through :class:`MatmulF32`, whose backward is JAX's.

Under Megatron tensor parallelism (a ``ParallelContext`` whose model axis
has more than one rank; each rank holds its blocks, ``sharding.
param_blocks``) the MLP's ``w_gate``/``w_in`` are split by columns and
``w_out`` by rows, whose f32 partial product is summed over the model
axis before the cast, as JAX's GSPMD sums the ``preferred_element_type``
output; the embedding and the head are split over the vocab. Under
autograd the forms of ``parallel.collectives`` carry the gradients: the
input of every split product goes through ``model_copy``, whose backward
sums the ranks' partial gradients over the model axis.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import collectives as coll

F32 = torch.float32
NEG_INF = -1e30


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's ``dtype`` string."""
    return {"bfloat16": torch.bfloat16, "float32": F32,
            "float16": torch.float16}[name]


def normal(gen, shape, device) -> torch.Tensor:
    """Standard normal f32 draws from ``gen`` (on the generator's device)."""
    return torch.randn(shape, generator=gen, dtype=F32, device=device)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device,
               scale: float = 1.0):
    std = scale / (in_dim ** 0.5)
    return (normal(gen, (in_dim, out_dim), device) * std).to(dtype)


class MatmulF32(torch.autograd.Function):
    """``x (M, i) @ w (i, o)`` in f32 from bf16/f16 operands on the card,
    with the JAX package's VJP of ``preferred_element_type=f32``: the f32
    cotangent times the other operand upcast to f32, in f32, then cast to
    the operand's dtype. (``torch.mm(out_dtype=)`` has no derivative of
    its own, and rounding the cotangent to bf16 first gives other bits.)"""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return MatmulF32.grads(x, w, g, ctx.needs_input_grad)

    @staticmethod
    def grads(x, w, g, needs=(True, True)):
        """(grad_x, grad_w) of cotangent ``g`` (None where not needed)."""
        gx = (g @ w.float().T).to(x.dtype) if needs[0] else None
        gw = (x.float().T @ g).to(w.dtype) if needs[1] else None
        return gx, gw


def needs_grad(*ts) -> bool:
    """True when autograd records a product of ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def matmul(x, w):
    """``x (..., i) @ w (i, o)`` returned in f32."""
    if x.dtype == F32 and w.dtype == F32:
        return x @ w
    if (x.is_cuda and x.dtype == w.dtype
            and x.dtype in (torch.bfloat16, torch.float16)):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        y = MatmulF32.apply(x2, w) if needs_grad(x, w) \
            else torch.mm(x2, w, out_dtype=F32)
        return y.reshape(*lead, w.shape[-1])
    return x.float() @ w.float()


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


# ---------------------------------------------------------------------------
# MLP (swiglu / gelu / squared-relu)
# ---------------------------------------------------------------------------

def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":  # jax.nn.gelu's default is the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def mlp_init(gen, cfg: ModelConfig, device, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg.dtype)
    return {
        "w_gate": dense_init(gen, d, f, dt, device),
        "w_in": dense_init(gen, d, f, dt, device),
        "w_out": dense_init(gen, f, d, dt, device),
    }


def mlp_apply(params, x, act: str = "silu", ctx=None, seq_dim=None):
    """The gated MLP. Under tensor parallelism ``params`` hold this rank's
    ``d_ff`` block and the ``w_out`` partials meet in a sum over the model
    axis (with ``seq_dim``, its reduce-scatter along the sequence); ``x``
    enters the column-split products through ``collectives.model_copy``
    (its gradient summed over the model axis)."""
    dt = x.dtype
    x = coll.model_copy(x, ctx)
    g = matmul(x, params["w_gate"])
    h = matmul(x, params["w_in"])
    y = act_fn(act)(g) * h
    y = matmul(y.to(dt), params["w_out"])
    return coll.model_reduce(y, ctx, seq_dim).to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE and qwen2-vl M-RoPE), split-halves convention
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=device)
                            / half))


def _rotate(x, ang):
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Temporal/height/width frequency split (fractions 1/4, 3/8, 3/8)."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return t, h, half - t - h


def apply_mrope(x, positions3, theta: float):
    """qwen2-vl M-RoPE. positions3: (3, ..., S) — temporal, h, w."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(hd, theta, x.device)
    t, h, w = mrope_sections(hd)
    sec = torch.cat([torch.full((n,), i, dtype=torch.int64, device=x.device)
                     for i, n in enumerate((t, h, w))])
    pos = torch.movedim(positions3, 0, -1)  # (..., S, 3)
    pos = torch.gather(pos, -1, sec.expand(*pos.shape[:-1], half))
    return _rotate(x, pos.float() * freqs)


# ---------------------------------------------------------------------------
# Embeddings and the LM head
# ---------------------------------------------------------------------------

def embed_init(gen, cfg: ModelConfig, device):
    v, d = cfg.padded_vocab, cfg.d_model
    shape = (cfg.num_codebooks, v, d) if cfg.num_codebooks else (v, d)
    return {"tok": (normal(gen, shape, device) * 0.02).to(
        dtype_of(cfg.dtype))}


def embed_apply(params, tokens, cfg: ModelConfig, ctx=None):
    """tokens: (B, S) int32 or (B, S, K) for codebook archs -> (B, S, D).
    Vocab-parallel under tensor parallelism: ``params["tok"]`` holds this
    rank's rows of the table ((K, V / tp, D) for codebooks: each
    codebook's vocab split); ids outside them give zero rows, and the
    sum over the model axis leaves each token its own row."""
    tok = params["tok"]
    if cfg.num_codebooks:
        if not coll.tensor_parallel(ctx):
            return sum(tok[k][tokens[..., k].long()]
                       for k in range(cfg.num_codebooks))
        # each codebook's rows summed over the model axis (one call: every
        # id is inside one rank's block, so the sum adds zeros), then the
        # codebooks added in order, as on one device
        rows = coll.model_psum(torch.stack([
            _vocab_rows(tok[k], tokens[..., k], ctx)
            for k in range(cfg.num_codebooks)]), ctx)
        return sum(rows[k] for k in range(cfg.num_codebooks))
    if not coll.tensor_parallel(ctx):
        return tok[tokens.long()]
    return coll.model_psum(_vocab_rows(tok, tokens, ctx), ctx)


def _vocab_rows(tok, tokens, ctx):
    """The rows of ``tokens`` in this rank's block of a vocab-split table
    (V / tp, D), zero for ids outside it."""
    v_loc = tok.shape[0]
    ids = tokens.long() - coll.model_rank(ctx) * v_loc
    inside = (ids >= 0) & (ids < v_loc)
    return torch.where(inside[..., None], tok[ids.clamp(0, v_loc - 1)], 0)


def lm_head_init(gen, cfg: ModelConfig, device):
    v, d = cfg.padded_vocab, cfg.d_model
    shape = (cfg.num_codebooks, d, v) if cfg.num_codebooks else (d, v)
    return {"w": (normal(gen, shape, device) / (d ** 0.5)).to(
        dtype_of(cfg.dtype))}


def lm_head_apply(params, x, cfg: ModelConfig, embed_params=None, ctx=None):
    """x: (B, S, D) -> f32 logits over the padded vocab with dead columns
    set to -1e30; shape (B, S, Vp) or (B, S, K, Vp). Under tensor
    parallelism the rank's vocab columns only, (B, S, Vp / tp): the dead
    columns are those whose global index is past the vocab
    (``collectives.model_gather`` on the last dim makes them whole), and
    ``x`` enters the product through ``collectives.model_copy``."""
    x = coll.model_copy(x, ctx)
    if cfg.tie_embeddings:
        logits = matmul(x, embed_params["tok"].T)
    elif cfg.num_codebooks:
        logits = torch.stack([matmul(x, params["w"][k])
                              for k in range(cfg.num_codebooks)], dim=2)
    else:
        logits = matmul(x, params["w"])
    if cfg.padded_vocab != cfg.vocab_size:
        first = coll.model_rank(ctx) * logits.shape[-1] \
            if coll.tensor_parallel(ctx) else 0
        logits[..., max(cfg.vocab_size - first, 0):] = NEG_INF
    return logits
