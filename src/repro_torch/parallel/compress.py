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


def compress(grads, err, amax=None):
    """Returns (int8 payloads, f32 scales, new residuals): what would
    cross the slow axis.

    ``amax``, where given, maps the 1-D tensor of the leaves' max |x| (in
    leaf order) to the maxima the scales are taken from. A rank that holds
    one block of each logical gradient passes the max over the blocks (a
    ``pmax``), so every block is quantized against the whole leaf's scale,
    as one device quantizes the whole leaf; the residuals stay blocks."""
    xs = tree_map(lambda g, e: g.float() + e, grads, err)
    flat = leaves(xs)
    mx = torch.stack([x.abs().max() for x in flat])
    if amax is not None:
        mx = amax(mx)
    scales = torch.clamp(mx, min=1e-12) / 127.0
    # tree_map walks insertion order, leaves() sorted order: match by leaf
    at = {id(x): i for i, x in enumerate(flat)}

    def one(x):
        scale = scales[at[id(x)]]
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return q, scale, x - q.float() * scale

    return unzip(tree_map(one, xs), 3)


def decompress(q, s):
    return tree_map(lambda qq, ss: qq.float() * ss, q, s)


def roundtrip(grads, err, amax=None):
    """Compress and decompress in one step (what the optimizer takes).
    Returns (dequantized grads, new residuals). ``amax`` as in
    :func:`compress`."""
    q, s, r = compress(grads, err, amax)
    return decompress(q, s), r


def compressed_bytes(params) -> int:
    """Bytes on the wire: one a parameter."""
    return sum(p.numel() for p in leaves(params))
