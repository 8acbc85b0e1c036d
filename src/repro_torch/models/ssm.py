"""State-space / linear-attention sequence mixers: one chunked gated
linear attention (GLA) engine for RWKV6's time mix and Hymba's Mamba
branch, as in the JAX package.

* rwkv6-1.6b (Finch): per-channel data-dependent decay and a bonus ``u``
  on the current token (exclusive recurrence).
* hymba-1.5b's Mamba branch: scalar per-head decay, inclusive recurrence.

Per head, with state S (dk, dv):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = q_t^T S_{t-1} + (q_t . (u * k_t)) v_t      (exclusive, rwkv6)
    y_t = q_t^T S_t                                   (inclusive, mamba)

Numerics follow the JAX package: the state and the decay sums are f32
whatever the layer's dtype; within a chunk the exponents ``L_t - L_j``
(t >= j) are non-positive and exponentiated directly, and across chunks
both factors at the chunk boundary have non-positive exponents, so a
strong decay never overflows. The part of a chunk that does not read the
carried state is computed for a block of chunks at once, batched over
batch and heads; only the state recurrence walks the chunks one by one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import _proj
from repro_torch.models.layers import (
    dense_init, dtype_of, matmul, normal, rmsnorm, rmsnorm_init,
)
from repro_torch.parallel import collectives as coll

F32 = torch.float32
# elements of one block's (B, n, T, T, H, dk) exponent tensor: the
# intra-chunk work is batched over as many chunks as stay under this
BLOCK_ELEMENTS = 1 << 26


def _pad_seq(x, pad):
    return F.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


def _intra(qb, kb, vb, wb, tri, u):
    """The state-free part of a block of chunks, (B, n, T, H, *) each, f32.
    Returns (qt, y_intra, bonus, decay (B, n, H, dk), kv (B, n, H, dk,
    dv)): the decayed queries that read the carried state, the in-chunk
    outputs, the current-token bonus (None when inclusive), each chunk's
    whole decay and its state increment."""
    inclusive = u is None
    L = torch.cumsum(wb, dim=2)  # inclusive cumulative log decay
    A = L if inclusive else L - wb  # the queries' exponent base
    qt = qb * torch.exp(A)  # exponents <= 0
    # E[t, j, d] = exp(A[t, d] - L[j, d]) where t > j (t >= j), else 0
    expo = A[:, :, :, None] - L[:, :, None, :]  # (B, n, T, T, H, dk)
    E = torch.where(tri[:, :, None, None], torch.exp(expo), 0.0)
    scores = (qb[:, :, :, None] * kb[:, :, None] * E).sum(-1)
    y = torch.einsum("bntjh,bnjhv->bnthv", scores, vb)
    bonus = None if inclusive else \
        (qb * u.float() * kb).sum(-1)[..., None] * vb
    decay = torch.exp(L[:, :, -1])
    kt = kb * torch.exp(L[:, :, -1:] - L)
    kv = torch.einsum("bnthk,bnthv->bnhkv", kt, vb)
    return qt, y, bonus, decay, kv


def chunked_gla(q, k, v, logw, u=None, *, chunk: int = 32, state=None):
    """q, k, logw: (B, S, H, dk); v: (B, S, H, dv); u: (H, dk) or None
    (None selects the inclusive recurrence). Returns (y (B, S, H, dv) in
    v's dtype, final state (B, H, dk, dv) f32)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    T = min(chunk, S)
    pad = (-S) % T
    # padding has logw = 0 (w = 1): harmless, its tokens are dropped
    q, k, v, logw = (_pad_seq(x, pad) for x in (q, k, v, logw))
    n = q.shape[1] // T
    qc = q.reshape(B, n, T, H, dk).float()
    kc = k.reshape(B, n, T, H, dk).float()
    vc = v.reshape(B, n, T, H, dv).float()
    wc = logw.reshape(B, n, T, H, dk).float()
    if state is None:
        state = torch.zeros((B, H, dk, dv), dtype=F32, device=q.device)
    tri = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device),
                     diagonal=0 if u is None else -1)
    per = max(1, BLOCK_ELEMENTS // (B * T * T * H * dk))
    ys = []
    for c0 in range(0, n, per):
        blk = slice(c0, min(n, c0 + per))
        qt, y_in, bonus, decay, kv = _intra(
            qc[:, blk], kc[:, blk], vc[:, blk], wc[:, blk], tri, u)
        # the carried state, chunk by chunk (factored at each chunk end)
        prev = []
        for c in range(kv.shape[1]):
            prev.append(state)
            state = state * decay[:, c, ..., None] + kv[:, c]
        # JAX's order: the state's part, the scores', the bonus
        y = torch.einsum("bnthk,bnhkv->bnthv", qt, torch.stack(prev, 1))
        y = y + y_in
        ys.append(y if bonus is None else y + bonus)
    y = torch.cat(ys, 1).reshape(B, n * T, H, dv)[:, :S]
    return y.to(v.dtype), state


def gla_step(q, k, v, logw, u, state):
    """One token. q, k, logw: (B, H, dk); v: (B, H, dv); state
    (B, H, dk, dv) f32. Returns (y (B, H, dv) in v's dtype, new state)."""
    qf, kf, vf, wf = (x.float() for x in (q, k, v, logw))
    new = state * torch.exp(wf)[..., None] + kf[..., None] * vf[..., None, :]
    if u is None:
        y = torch.einsum("bhk,bhkv->bhv", qf, new)
    else:
        y = torch.einsum("bhk,bhkv->bhv", qf, state)
        y = y + (qf * u.float() * kf).sum(-1)[..., None] * vf
    return y.to(v.dtype), new


# ---------------------------------------------------------------------------
# RWKV6 (Finch) blocks
# ---------------------------------------------------------------------------

def _shift(x, prev=None):
    """Token shift: x[t] -> x[t-1]; position 0 gets ``prev`` (or zeros)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _heads(cfg: ModelConfig):
    hd = cfg.resolved_head_dim or 64
    return cfg.d_model // hd, hd


def rwkv_tmix_init(gen, cfg: ModelConfig, device):
    d = cfg.d_model
    h, hd = _heads(cfg)
    dt = dtype_of(cfg.dtype)
    lora = 64

    def full(shape, value):
        return torch.full(shape, value, dtype=dt, device=device)

    def proj():
        return dense_init(gen, d, h * hd, dt, device).reshape(d, h, hd)

    p = {f"mu_{c}": full((d,), 0.5) for c in "rkvgw"}
    p.update(wr=proj(), wk=proj(), wv=proj(), wg=proj())
    # data-dependent decay: w0 + tanh(x @ A) @ B (the Finch signature)
    p["w0"] = full((h, hd), -2.0)
    p["wlA"] = dense_init(gen, d, lora, dt, device, scale=0.1)
    p["wlB"] = dense_init(gen, lora, h * hd, dt, device, scale=0.1)
    p["u"] = (normal(gen, (h, hd), device) * 0.1).to(dt)
    p["w_out"] = dense_init(gen, h * hd, d, dt, device).reshape(h, hd, d)
    p["gn"] = {"scale": full((h, hd), 1.0)}
    return p


def rwkv_tmix_apply(p, x, cfg: ModelConfig, *, prev=None, state=None,
                    chunk: int = 32, ctx=None):
    """x: (B, S, D). Returns (y, (last x, new state)).

    Under tensor parallelism ``p`` holds the rank's heads of the (D, H,
    hd) projections and of ``w_out`` (H, hd, D); the per-head vectors
    ``w0``, ``u``, ``gn`` and the decay LoRA's ``wlB`` are replicated
    (2-D: the head rule does not match them) and the rank takes its
    heads' slice of them. The recurrence and the group norm are per
    head, so rank-local; ``state`` holds the rank's heads, and the
    row-split ``w_out`` partials are summed over the model axis before
    the cast."""
    B, S, D = x.shape
    h, hd = _heads(cfg)
    hl = p["wr"].shape[1]  # this rank's heads
    heads = slice(coll.model_rank(ctx) * hl, (coll.model_rank(ctx) + 1) * hl)
    xx = _shift(x, prev)

    def lerp(mu):
        return x + (xx - x) * mu.to(x.dtype)

    r, k, v, g = (_proj(lerp(p[f"mu_{c}"]), p[f"w{c}"]) for c in "rkvg")
    xw = lerp(p["mu_w"])
    wlb = p["wlB"][:, heads.start * hd:heads.stop * hd] if hl != h \
        else p["wlB"]
    lo = torch.tanh(xw.float() @ p["wlA"].float()) @ wlb.float()
    ww = p["w0"][heads].float()[None, None] + lo.reshape(B, S, hl, hd)
    logw = -torch.exp(torch.clamp(ww, -20.0, 3.0))  # decay in (0, 1)

    y, new_state = chunked_gla(r, k, v, logw, p["u"][heads], chunk=chunk,
                               state=state)
    # per-head group norm, then silu(g) gating
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yn = (yf - mu) * torch.rsqrt(var + 1e-5) \
        * p["gn"]["scale"][heads].float()
    out = (F.silu(g) * yn).to(x.dtype)
    w = p["w_out"]
    out = matmul(out.reshape(B, S, hl * hd), w.reshape(hl * hd, D))
    return coll.model_psum(out, ctx).to(x.dtype), (x[:, -1], new_state)


def rwkv_cmix_init(gen, cfg: ModelConfig, device):
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg.dtype)
    half = torch.full((d,), 0.5, dtype=dt, device=device)
    return {
        "mu_k": half,
        "mu_r": half.clone(),
        "wk": dense_init(gen, d, f, dt, device),
        "wv": dense_init(gen, f, d, dt, device),
        "wr": dense_init(gen, d, d, dt, device),
    }


def rwkv_cmix_apply(p, x, *, prev=None, ctx=None):
    """x: (B, S, D). Returns (y, last x). The products round to x's dtype
    where the JAX package's bf16 products do.

    Under tensor parallelism ``wk`` (D, F), ``wv`` (F, D) and ``wr`` (D,
    D) are all column blocks (the JAX package's rule splits a 2-D
    channel-mix weight's last dim, and its ``w_out`` rule never matches
    ``wv``): the rank's block of ``k`` is gathered whole before ``wv``,
    and its D block of the output is gathered after the gate. Every
    column is computed as on one device: no partial sum crosses ranks."""
    dt = x.dtype
    xx = _shift(x, prev)
    xk = x + (xx - x) * p["mu_k"].to(dt)
    xr = x + (xx - x) * p["mu_r"].to(dt)
    k = torch.square(F.relu(matmul(xk, p["wk"]).to(dt)))
    k = coll.model_gather(k, ctx, -1)
    r = torch.sigmoid(matmul(xr, p["wr"]).to(dt).float()).to(dt)
    y = r * matmul(k, p["wv"]).to(dt)
    return coll.model_gather(y, ctx, -1), x[:, -1]


# ---------------------------------------------------------------------------
# Mamba2-style branch (hymba)
# ---------------------------------------------------------------------------

def _mamba_dims(cfg: ModelConfig):
    d = cfg.d_model
    din = d * cfg.ssm_expand
    hd = 64 if din % 64 == 0 else din
    return d, din, hd, din // hd


def mamba_init(gen, cfg: ModelConfig, device):
    d, din, hd, h = _mamba_dims(cfg)
    ns = cfg.ssm_state
    dt = dtype_of(cfg.dtype)
    return {
        "in_proj": dense_init(gen, d, 2 * din, dt, device),  # x and gate z
        "bc_proj": dense_init(gen, d, 2 * ns, dt, device),  # B_t, C_t
        "dt_proj": dense_init(gen, d, h, dt, device, scale=0.1),
        "dt_bias": torch.zeros((h,), dtype=dt, device=device),
        "a_log": torch.zeros((h,), dtype=dt, device=device),  # decay rate
        "d_skip": torch.ones((h,), dtype=dt, device=device),
        "out_proj": dense_init(gen, din, d, dt, device),
        "norm": rmsnorm_init(din, dt, device),
    }


def mamba_apply(p, x, cfg: ModelConfig, *, state=None, chunk: int = 32):
    """x: (B, S, D) -> (y, new state (B, H, ssm_state, hd) f32): the
    inclusive recurrence with a scalar decay per head."""
    B, S, D = x.shape
    _, din, hd, h = _mamba_dims(cfg)
    ns = cfg.ssm_state
    dt = x.dtype
    xi, z = matmul(x, p["in_proj"]).to(dt).chunk(2, dim=-1)  # (B, S, din)
    b_t, c_t = matmul(x, p["bc_proj"]).to(dt).chunk(2, dim=-1)  # (B, S, ns)
    dt_ = F.softplus(matmul(x, p["dt_proj"]).to(dt).float()
                     + p["dt_bias"].float())  # (B, S, h)
    logw = -dt_ * torch.exp(p["a_log"].float())[None, None]  # <= 0

    v = (xi.float() * torch.repeat_interleave(dt_, hd, dim=-1)).reshape(
        B, S, h, hd)
    k = b_t[:, :, None, :].expand(B, S, h, ns)
    q = c_t[:, :, None, :].expand(B, S, h, ns)
    lw = logw[..., None].expand(B, S, h, ns)
    y, new_state = chunked_gla(q, k, v.to(dt), lw, None, chunk=chunk,
                               state=state)
    y = y.float() + xi.reshape(B, S, h, hd).float() \
        * p["d_skip"].float()[None, None, :, None]
    y = rmsnorm(p["norm"], y.reshape(B, S, din).to(dt), 1e-6)
    y = y * F.silu(z.float()).to(dt)
    return matmul(y, p["out_proj"]).to(dt), new_state


def mamba_step(p, x, cfg: ModelConfig, state):
    """x: (B, D), one token. Returns (y (B, D), new state)."""
    y, new_state = mamba_apply(p, x[:, None], cfg, state=state, chunk=1)
    return y[:, 0], new_state
