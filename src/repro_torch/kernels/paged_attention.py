"""Wrapper of the CUDA paged decode attention (``csrc/paged_attention.cu``).

``paged_attention_stats`` returns the raw online-softmax state (acc, m, l)
of each query row over the tokens a sequence holds in the paged pool, so
the read-only decode path can LSE-merge the current token's fresh k/v
afterwards; ``paged_attention`` adds the final divide. Each (sequence, kv
head) is one cluster of :func:`splits` CTAs, each walking a contiguous
range of :func:`split_len` tokens, merged inside the launch; the split
depends on the page table's width alone, so the wrapper never reads the
lengths back. The wrapper follows ``_launch`` (CUDA tensors only,
checked, launched on the current stream); ``launches`` counts launches
since the last :func:`reset_launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import I, P, Library, check, same

KERNELS = ("paged_attention_stats",)
MAX_GROUP = 8  # G: one warp per query row
MAX_HEAD_DIM = 256  # 8 accumulator values a lane
MAX_ROW_BYTES = 512  # a page row
MAX_SPLITS = 8  # CTAs of a cluster: the portable cluster size
SPLIT_TOKENS = 2048  # table tokens per split
_ENTRIES = {torch.float32: "orca_paged_attention_stats_f32",
            torch.bfloat16: "orca_paged_attention_stats_bf16"}
_lib = Library("paged_attention", KERNELS, {
    e: [P] * 8 + [I] * 9 for e in _ENTRIES.values()
})
launches = _lib.launches
reset_launches = _lib.reset


def splits(maxp: int, ps: int) -> int:
    """CTAs per (sequence, kv head) for a page table of ``maxp`` pages of
    ``ps`` tokens: one per SPLIT_TOKENS table tokens, 1 to MAX_SPLITS."""
    return max(1, min(MAX_SPLITS, -(-maxp * ps // SPLIT_TOKENS)))


def split_len(maxp: int, ps: int, n: int) -> int:
    """Tokens each of ``n`` splits walks: the table's tokens, cut into
    ``n`` contiguous ranges (the last one may be shorter or empty)."""
    return max(1, -(-maxp * ps // n))


def paged_attention_stats(q, k_pages, v_pages, page_table, lengths):
    """q: (B, KVH, G, hd) f32, pre-scaled; pages: (NP, PS, KVH, hd) f32 or
    bf16 (the last page the zero sentinel); page_table: (B, MaxP) int32,
    -1 = unmapped; lengths: (B,) int32. Returns (acc (B, KVH, G, hd),
    m (B, KVH, G), l (B, KVH, G)), f32."""
    dev = q.device
    check("q", q, 4, dev, dtype=torch.float32)
    check("k_pages", k_pages, 4, dev, dtype=tuple(_ENTRIES))
    check("v_pages", v_pages, 4, dev, dtype=k_pages.dtype)
    check("page_table", page_table, 2, dev)
    check("lengths", lengths, 1, dev)
    b, kvh, g, hd = q.shape
    n_pages, ps = k_pages.shape[:2]
    same("k_pages", k_pages.shape[2:], (kvh, hd))
    same("v_pages", v_pages.shape, k_pages.shape)
    same("page_table", page_table.shape[:1], (b,))
    same("lengths", lengths.shape, (b,))
    if g > MAX_GROUP:
        raise ValueError(f"paged_attention_stats: G = {g} > {MAX_GROUP}")
    if hd % 8 or hd > MAX_HEAD_DIM \
            or hd * k_pages.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"paged_attention_stats: head_dim {hd} must be a "
                         f"multiple of 8, at most {MAX_HEAD_DIM}, with rows "
                         f"of at most {MAX_ROW_BYTES} bytes")
    maxp = page_table.shape[1]
    n = splits(maxp, ps)
    acc = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=dev)
    m = torch.empty((b, kvh, g), dtype=torch.float32, device=dev)
    l = torch.empty((b, kvh, g), dtype=torch.float32, device=dev)
    _lib.launch("paged_attention_stats", _ENTRIES[k_pages.dtype], dev,
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
                m.data_ptr(), l.data_ptr(), b, kvh, g, hd, n_pages, ps, maxp,
                n, split_len(maxp, ps, n))
    return acc, m, l
