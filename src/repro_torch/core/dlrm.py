"""ORCA-DLRM (§IV-C): recommendation inference as CPU↔accelerator
collaboration.

The split follows the paper exactly:
* the **host** (= the paper's server CPU) runs the irregular, branch-rich
  request preprocessing — parsing, and the MERCI sub-query memoization
  rewrite (numpy, :class:`MerciIndex`);
* the **device** (= the cc-accelerator APU) runs the memory-bound embedding
  reduction — a wide batched gather+segment-sum, the ``64 outstanding memory
  requests per query`` loop of §IV-C — plus the dense bottom/top MLPs and
  feature interactions.

The embedding reduction goes through ``kernels.ops``, which dispatches
between the CUDA kernel (``kernels/csrc/embedding_reduce.cu``) and its
plain PyTorch version by the ``backend`` knob (``auto | cuda | ref``). The
MLPs and interactions are plain ``torch.matmul``/``einsum`` over the params
dict, as the JAX package leaves them to XLA.

MERCI (the paper's algorithmic baseline, Fig. 12): rows of each table are
grouped into clusters; sums of frequently co-occurring pairs inside a
cluster are precomputed into a memoization table sized ``memo_ratio`` × the
original. The host rewrites each query's index list, replacing matched pairs
by a single memo row (second member -> a shared zero row), so the device
issues fewer gathers for the same result.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import status as stc
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

F32 = torch.float32
I32 = torch.int32


class DLRMConfig(NamedTuple):
    num_tables: int = 8
    rows: int = 4096  # rows per table
    dim: int = 64  # embedding dim (paper default)
    lookups: int = 32  # multi-hot lookups per table per query
    dense_features: int = 13
    bottom: tuple = (128, 64)
    top: tuple = (128, 64, 1)
    memo_ratio: float = 0.25
    cluster: int = 4  # rows per MERCI cluster


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(cfg: DLRMConfig, generator: Optional[torch.Generator] = None,
                device="cuda", dtype=F32):
    """Random params as a dict: ``tables`` (T, R, D) drawn N(0, 1) · 0.1,
    MLP weights (d_in, d_out) drawn N(0, 1) / √d_in, zero biases — the JAX
    package's shapes and distributions. The draws come from ``generator``
    on its own device (the default generator when None) and are moved to
    ``device``; they cannot replay ``jax.random``, so tests carry JAX's
    params across (``interop.dlrm_params_from_numpy``)."""
    draw_on = generator.device if generator is not None else device

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=F32,
                           device=draw_on).to(device)

    tables = (normal((cfg.num_tables, cfg.rows, cfg.dim)) * 0.1).to(dtype)

    def mlp(dims, d_in):
        layers = []
        for d_out in dims:
            w = normal((d_in, d_out)) / (d_in ** 0.5)
            layers.append({"w": w.to(dtype),
                           "b": torch.zeros((d_out,), dtype=dtype,
                                            device=device)})
            d_in = d_out
        return layers

    n_int = cfg.num_tables * (cfg.num_tables + 1) // 2  # pairwise dots + dense
    bottom = mlp(cfg.bottom + (cfg.dim,), cfg.dense_features)
    top = mlp(cfg.top, cfg.dim + n_int)
    return {"tables": tables, "bottom": bottom, "top": top}


# ---------------------------------------------------------------------------
# Embedding reduction (the device hot loop: CUDA kernel + plain version)
# ---------------------------------------------------------------------------

def embedding_reduce(tables, idx, *, backend: Optional[str] = None):
    """tables: (T, R', D); idx: (B, T, L) int32 -> (B, T, D) f32 sum-pool.

    R' may exceed cfg.rows when a memo extension is appended. ``backend``
    is the kernel dispatch knob (``auto | cuda | ref``); the default
    (None) and ``ref`` run :func:`kernels.ref.dlrm_embedding_reduce`, which
    adds the lookups one after another — the order of the kernel's
    per-segment accumulator, so every backend agrees bit for bit."""
    if backend is None or backend == "ref":
        return kref.dlrm_embedding_reduce(tables, idx)
    t, r, d = tables.shape
    b, _, l = idx.shape
    dev = idx.device
    # flatten to the kernel's (table rows, sorted segment ids) layout:
    # segment (b, t) -> b*T + t, non-decreasing in (B, T, L) flatten order
    flat_idx = (idx.to(I32)
                + torch.arange(t, dtype=I32, device=dev)[None, :, None] * r)
    seg = torch.arange(b * t, dtype=I32, device=dev).repeat_interleave(l)
    out = kops.embedding_reduce(
        tables.reshape(t * r, d), flat_idx.reshape(-1), seg, b * t,
        backend=backend,
    )
    return out.reshape(b, t, d)


def _mlp_apply(layers, x, final_linear=False):
    for i, layer in enumerate(layers):
        w, bias = layer["w"], layer["b"]
        dt = torch.promote_types(torch.promote_types(x.dtype, w.dtype),
                                 bias.dtype)
        x = x.to(dt) @ w.to(dt) + bias.to(dt)
        if not (final_linear and i == len(layers) - 1):
            x = torch.relu(x)
    return x


def forward(params, dense, idx, cfg: DLRMConfig, tables_ext=None, *,
            backend: Optional[str] = None):
    """dense: (B, F); idx: (B, T, L) -> CTR logits (B,).

    ``tables_ext``: optional extended tables (raw ‖ memo ‖ zero-row) when the
    host rewrote idx with MERCI references. ``backend`` routes the embedding
    reduction (the device hot loop) through the CUDA kernel."""
    tables = tables_ext if tables_ext is not None else params["tables"]
    emb = embedding_reduce(tables, idx, backend=backend).to(F32)  # (B, T, D)
    bot = _mlp_apply(params["bottom"], dense.to(F32))  # (B, D)
    feats = torch.cat([bot[:, None, :], emb.to(bot.dtype)], dim=1)
    inter = torch.einsum("bmd,bnd->bmn", feats, feats)
    iu, ju = torch.triu_indices(cfg.num_tables + 1, cfg.num_tables + 1,
                                offset=1, device=inter.device)
    flat = inter[:, iu, ju]  # (B, (T+1)T/2)
    z = torch.cat([bot, flat], dim=1)
    return _mlp_apply(params["top"], z, final_linear=True)[:, 0]


# ---------------------------------------------------------------------------
# Request-level interface (engine app): DLRM inference through the rings.
# word0 = op (0 nop / 1 infer), words[1:1+F] = dense features (f32 bit-
# cast), rest = the (T*L) embedding indices (host-rewritten when MERCI is
# on). Response: word0 = status (1 ok), word1 = CTR logit (f32 bit-cast).
# ---------------------------------------------------------------------------

OP_NOP, OP_INFER = 0, 1


def request_words(cfg: DLRMConfig) -> int:
    return 1 + cfg.dense_features + cfg.num_tables * cfg.lookups


def app_step(params, payloads, valid, cfg: DLRMConfig, *, tables_ext=None,
             kernel_backend: Optional[str] = "auto"):
    """Engine hook: payloads (B, 1+F+T*L) int32 -> (params, responses).

    The APU half of the §IV-C collaboration: the embedding reduction (and
    the dense MLPs) run device-side per request batch, through the CUDA
    kernel when ``kernel_backend`` selects it. ``tables_ext`` carries the
    MERCI-extended tables when the host rewrote the index lists. An
    unknown opcode, or an INFER with an embedding index outside the
    tables, NACKs as MALFORMED."""
    tables = tables_ext if tables_ext is not None else params["tables"]
    f = cfg.dense_features
    op = payloads[:, 0]
    dense = payloads[:, 1: 1 + f].contiguous().view(F32)
    raw_idx = payloads[:, 1 + f: 1 + f + cfg.num_tables * cfg.lookups]
    bad = valid & (
        ~((op == OP_NOP) | (op == OP_INFER))
        | ((op == OP_INFER)
           & torch.any((raw_idx < 0) | (raw_idx >= tables.shape[1]), dim=1))
    )
    idx = torch.clamp(raw_idx, 0, tables.shape[1] - 1).reshape(
        payloads.shape[0], cfg.num_tables, cfg.lookups
    )
    live = valid & ~bad & (op == OP_INFER)
    logits = forward(params, dense, idx, cfg, tables_ext=tables_ext,
                     backend=kernel_backend)
    logit_bits = torch.where(live, logits, 0.0).to(F32).contiguous().view(I32)
    status = torch.where(bad, stc.MALFORMED, live.to(I32)).to(I32)
    resp = torch.zeros_like(payloads)
    resp[:, 0] = status
    resp[:, 1] = logit_bits
    return params, resp


# ---------------------------------------------------------------------------
# MERCI memoization (host side — the "CPU" of the collaboration)
# ---------------------------------------------------------------------------

class MerciIndex:
    """Per-table pair-memoization built offline from cluster structure.

    Memo entry m of table t holds ``table[t,a] + table[t,b]`` for a chosen
    in-cluster pair (a, b). Queries are rewritten on the host: every matched
    (a, b) pair collapses to one reference at offset ``rows + m``; the freed
    slot points at the shared zero row (offset ``rows + n_memo``). One numpy
    seed gives the JAX package's pairs."""

    def __init__(self, cfg: DLRMConfig, seed: int = 0):
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        n_memo = int(cfg.rows * cfg.memo_ratio)
        self.n_memo = n_memo
        # pick pairs within clusters (cluster c = rows [c*k, (c+1)*k))
        k = cfg.cluster
        n_clusters = cfg.rows // k
        pairs = np.zeros((cfg.num_tables, n_memo, 2), np.int32)
        for t in range(cfg.num_tables):
            cl = rng.integers(0, n_clusters, size=n_memo)
            a = rng.integers(0, k, size=n_memo)
            off = 1 + rng.integers(0, k - 1, size=n_memo)
            b = (a + off) % k
            pairs[t, :, 0] = cl * k + np.minimum(a, b)
            pairs[t, :, 1] = cl * k + np.maximum(a, b)
        self.pairs = pairs
        # pair -> memo id lookup per table
        self.lookup = [
            {(int(a), int(b)): m for m, (a, b) in enumerate(pairs[t])}
            for t in range(cfg.num_tables)
        ]

    def build_tables(self, tables) -> torch.Tensor:
        """(T, R, D) -> (T, R + n_memo + 1, D) with memo sums + zero row,
        on the tables' device and in their dtype. The memo sums are f32
        adds on the host, as in the JAX package."""
        t = tables.detach().to(F32).cpu().numpy()
        ti = np.arange(self.cfg.num_tables)[:, None]
        memo = t[ti, self.pairs[..., 0]] + t[ti, self.pairs[..., 1]]
        zero = np.zeros((self.cfg.num_tables, 1, self.cfg.dim), np.float32)
        ext = np.concatenate([t, memo, zero], axis=1)
        return torch.from_numpy(ext).to(device=tables.device,
                                        dtype=tables.dtype)

    def rewrite_query(self, idx: np.ndarray) -> tuple[np.ndarray, int]:
        """idx: (B, T, L) raw -> rewritten (B, T, L) into the extended table.
        Returns (new_idx, gathers_saved). Host-side, irregular — numpy.
        It loops in Python over every memo pair for every (query, table),
        so it is affordable only at small tables."""
        cfg = self.cfg
        b = idx.shape[0]
        out = idx.copy()
        zero_row = cfg.rows + self.n_memo
        saved = 0
        for bi in range(b):
            for t in range(cfg.num_tables):
                row = out[bi, t]
                present = set(int(x) for x in row)
                used = np.zeros(len(row), bool)
                pos_of: dict[int, list] = {}
                for p, v in enumerate(row):
                    pos_of.setdefault(int(v), []).append(p)
                for (a, bb_), m in self.lookup[t].items():
                    if a in present and bb_ in present and a != bb_:
                        pa = next((p for p in pos_of[a] if not used[p]), None)
                        pb = next((p for p in pos_of[bb_] if not used[p]), None)
                        if pa is None or pb is None:
                            continue
                        out[bi, t, pa] = cfg.rows + m
                        out[bi, t, pb] = zero_row
                        used[pa] = used[pb] = True
                        saved += 1
        return out, saved


def gen_queries(cfg: DLRMConfig, batch: int, merci: Optional[MerciIndex],
                hit_rate: float, rng: np.random.Generator):
    """Synthetic Amazon-Review-style queries: with probability ``hit_rate``
    a lookup slot pair is drawn from a memoized pair (co-occurrence skew).
    Host numpy; one seed gives the JAX package's queries."""
    idx = rng.integers(0, cfg.rows, size=(batch, cfg.num_tables, cfg.lookups))
    if merci is not None and hit_rate > 0:
        n_pairs = cfg.lookups // 2
        for t in range(cfg.num_tables):
            pick = rng.integers(0, merci.n_memo, size=(batch, n_pairs))
            use = rng.random((batch, n_pairs)) < hit_rate
            pa = merci.pairs[t, pick]  # (B, P, 2)
            for p in range(n_pairs):
                sel = use[:, p]
                idx[sel, t, 2 * p] = pa[sel, p, 0]
                idx[sel, t, 2 * p + 1] = pa[sel, p, 1]
    dense = rng.normal(size=(batch, cfg.dense_features)).astype(np.float32)
    return dense, idx.astype(np.int32)
