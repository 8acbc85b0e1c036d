"""Wrapper of the CUDA causal prefill attention (``csrc/flash_attention.cu``).

Causal flash attention with GQA and an optional sliding window, forward
only, the online softmax in f32 and the output in q's dtype. The wrapper
follows ``_launch`` (CUDA tensors only, checked, launched on the current
stream); ``launches`` counts launches since the last
:func:`reset_launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import I, P, Library, check, same

KERNELS = ("flash_attention",)
MAX_HEAD_DIM = 256
_ENTRIES = {torch.float32: "orca_flash_attention_f32",
            torch.bfloat16: "orca_flash_attention_bf16"}
_lib = Library("flash_attention", KERNELS, {
    e: [P] * 4 + [I] * 6 + [ctypes.c_float] for e in _ENTRIES.values()
})
launches = _lib.launches
reset_launches = _lib.reset


def flash_attention(q, k, v, *, window: int = 0):
    """q: (B, H, S, hd); k, v: (B, KVH, S, hd), H % KVH == 0, all f32 or
    all bf16. Causal (and windowed when ``window`` > 0). Returns
    (B, H, S, hd) in q's dtype."""
    dev = q.device
    check("q", q, 4, dev, dtype=tuple(_ENTRIES))
    check("k", k, 4, dev, dtype=q.dtype)
    check("v", v, 4, dev, dtype=q.dtype)
    b, h, s, hd = q.shape
    kvh = k.shape[1]
    same("k", k.shape, (b, kvh, s, hd))
    same("v", v.shape, k.shape)
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: {h} heads over {kvh} kv heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} > {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    _lib.launch("flash_attention", _ENTRIES[q.dtype], dev,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, h, kvh, s, hd, int(window), float(hd ** -0.5))
    return out
