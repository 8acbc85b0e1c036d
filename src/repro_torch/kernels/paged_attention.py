"""Wrapper of the CUDA paged decode attention (``csrc/paged_attention.cu``).

``paged_attention_stats`` returns the raw online-softmax state (acc, m, l)
of each query row over the tokens a sequence holds in the paged pool, so
the read-only decode path can LSE-merge the current token's fresh k/v
afterwards; ``paged_attention`` adds the final divide. The wrapper follows
``_launch`` (CUDA tensors only, checked, launched on the current stream);
``launches`` counts launches since the last :func:`reset_launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import I, P, Library, check, same

KERNELS = ("paged_attention_stats",)
MAX_GROUP = 8  # G: one warp per query row
MAX_HEAD_DIM = 256  # 8 accumulator values a lane
MAX_ROW_BYTES = 512  # a page row: 16-byte loads, at most 8 a thread
_ENTRIES = {torch.float32: "orca_paged_attention_stats_f32",
            torch.bfloat16: "orca_paged_attention_stats_bf16"}
_lib = Library("paged_attention", KERNELS, {
    e: [P] * 8 + [I] * 7 for e in _ENTRIES.values()
})
launches = _lib.launches
reset_launches = _lib.reset


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
    acc = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=dev)
    m = torch.empty((b, kvh, g), dtype=torch.float32, device=dev)
    l = torch.empty((b, kvh, g), dtype=torch.float32, device=dev)
    _lib.launch("paged_attention_stats", _ENTRIES[k_pages.dtype], dev,
                q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), acc.data_ptr(),
                m.data_ptr(), l.data_ptr(), b, kvh, g, hd, n_pages, ps,
                page_table.shape[1])
    return acc, m, l
