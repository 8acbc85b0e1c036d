"""Wrapper of the CUDA causal prefill attention (``csrc/flash_attention.cu``).

Causal flash attention with GQA and an optional sliding window, forward
only, the online softmax in f32 and the output in q's dtype. The wrapper
follows ``_launch`` (CUDA tensors only, checked, launched on the current
stream), except that q, k and v may be any (B, H, S, hd) views whose last
dimension is contiguous: the kernel takes their strides, so the model's
(B, S, H, hd) tensors need no copy. ``launches`` counts launches since
the last :func:`reset_launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._launch import I, P, Library, check, same

KERNELS = ("flash_attention",)
MAX_HEAD_DIM = 256
TMA_HEAD_DIMS = (64, 128)  # bf16 head dims of the TMA/wgmma path
_ENTRIES = {torch.float32: "orca_flash_attention_f32",
            torch.bfloat16: "orca_flash_attention_bf16"}
_lib = Library("flash_attention", KERNELS, {
    e: [P] * 5 + [I] * 6 + [ctypes.c_float] for e in _ENTRIES.values()
})
launches = _lib.launches
reset_launches = _lib.reset


def _strides(name, t, tma):
    """(b, h, s) element strides of a (B, H, S, hd) view; raises unless
    hd is contiguous, and, for the TMA path, unless every stride and the
    address are 16-byte aligned."""
    sb, sh, ss, sd = t.stride()
    if sd != 1:
        raise ValueError(f"flash_attention: {name} has last stride {sd}; "
                         "the head dimension must be contiguous")
    if tma and (any(x * t.element_size() % 16 for x in (sb, sh, ss))
                or t.data_ptr() % 16):
        raise ValueError(f"flash_attention: {name}'s strides {t.stride()} "
                         "and address must be 16-byte aligned")
    return sb, sh, ss


def flash_attention(q, k, v, *, window: int = 0):
    """q: (B, H, S, hd); k, v: (B, KVH, S, hd), H % KVH == 0, all f32 or
    all bf16, each with a contiguous last dimension and any other strides.
    Causal (and windowed when ``window`` > 0). Returns (B, H, S, hd) in
    q's dtype: a view of a (B, S, H, hd) tensor."""
    dev = q.device
    check("q", q, 4, dev, dtype=tuple(_ENTRIES), contiguous=False)
    check("k", k, 4, dev, dtype=q.dtype, contiguous=False)
    check("v", v, 4, dev, dtype=q.dtype, contiguous=False)
    b, h, s, hd = q.shape
    kvh = k.shape[1]
    same("k", k.shape, (b, kvh, s, hd))
    same("v", v.shape, k.shape)
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: {h} heads over {kvh} kv heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} > {MAX_HEAD_DIM}")
    tma = q.dtype == torch.bfloat16 and hd in TMA_HEAD_DIMS
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=dev)
    view = out.transpose(1, 2)
    strides = [x for name, t in (("q", q), ("k", k), ("v", v),
                                 ("out", view))
               for x in _strides(name, t, tma)]
    arr = (ctypes.c_longlong * 12)(*strides)
    _lib.launch("flash_attention", _ENTRIES[q.dtype], dev,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ctypes.addressof(arr), b, h, kvh, s, hd, int(window),
                float(hd ** -0.5))
    return view
