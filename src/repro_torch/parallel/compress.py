"""Gradient compression: int8 quantization with error feedback, the JAX
package's ``repro/parallel/compress.py``.

Each leaf plus its carried residual is quantized to int8 against one
per-tensor scale (max |x| / 127); what the quantization lost is carried
to the next step (error-feedback SGD), so the applied updates converge to
the true gradient sum. ``torch.round`` rounds half to even, as
``jnp.round`` does, so both packages give the same bits.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.tree import leaves, tree_map, unzip

F32 = torch.float32


def init_error(params) -> Any:
    """Zero f32 residuals shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)


def compress(grads, err):
    """Returns (int8 payloads, f32 scales, new residuals): what would
    cross the slow axis."""
    def one(g, e):
        x = g.float() + e
        scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return q, scale, x - q.float() * scale

    return unzip(tree_map(one, grads, err), 3)


def decompress(q, s):
    return tree_map(lambda qq, ss: qq.float() * ss, q, s)


def roundtrip(grads, err):
    """Compress and decompress in one step (what the optimizer takes).
    Returns (dequantized grads, new residuals)."""
    q, s, r = compress(grads, err)
    return decompress(q, s), r


def compressed_bytes(params) -> int:
    """Bytes on the wire: one a parameter."""
    return sum(p.numel() for p in leaves(params))
