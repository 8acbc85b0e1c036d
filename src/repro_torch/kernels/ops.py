"""Dispatch between the CUDA kernels and their plain PyTorch versions.

The knob is the engine's ``kernel_backend``: ``auto`` takes the kernel for
CUDA tensors and the plain version for CPU tensors (the CPU has no kernel
to run, and no interpret mode); ``cuda`` takes the kernel and raises on
CPU tensors; ``ref`` takes the plain version on either device. A CUDA
tensor under ``auto`` or ``cuda`` always launches the kernel: a build or
launch failure raises, it never falls back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import embedding_reduce as _er
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hash_probe as _hp
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tx_commit as _tc


def resolve_backend(backend, device) -> bool:
    """Map the ``kernel_backend`` knob and the tensors' device to
    ``use_ref``: True routes to :mod:`ref`, False to the CUDA kernels."""
    if backend in (None, "auto"):
        return device.type != "cuda"
    if backend == "cuda":
        if device.type != "cuda":
            raise ValueError(
                f"kernel_backend='cuda' needs CUDA tensors, got {device}; "
                "use 'auto' or 'ref' on the CPU"
            )
        return False
    if backend == "ref":
        return True
    raise ValueError(
        f"unknown kernel_backend {backend!r} (expected auto | cuda | ref)"
    )


def hash_probe(bucket_keys, bucket_ptr, keys, h1, h2, *, backend="auto"):
    """Two-bucket existence probe. Returns (found (B,), ptr (B,)): the first
    two memory accesses of both the GET walk and the PUT plan."""
    if resolve_backend(backend, keys.device):
        return _ref.hash_probe(bucket_keys, bucket_ptr, keys, h1, h2)
    return _hp.probe(bucket_keys, bucket_ptr, keys, h1, h2)


def cache_probe(cache_keys, cache_vals, cache_meta, keys, cset, *,
                backend="auto"):
    """Hot-set cache lookup. Returns (hit (B,), way (B,), vals (B, VW))."""
    if resolve_backend(backend, keys.device):
        return _ref.cache_probe(cache_keys, cache_vals, cache_meta, keys, cset)
    return _hp.cache_probe(cache_keys, cache_vals, cache_meta, keys, cset)


def hash_get(bucket_keys, bucket_ptr, pool, keys, h1, h2, *, backend="auto"):
    """GET walk: probe + fetch, one ``get_walk`` launch on CUDA tensors.
    Returns (vals (B, VW), found (B,))."""
    if resolve_backend(backend, keys.device):
        return _ref.hash_get(bucket_keys, bucket_ptr, pool, keys, h1, h2)
    return _hp.get(bucket_keys, bucket_ptr, pool, keys, h1, h2)


def hash_put(bucket_keys, bucket_ptr, pool, keys, vals, tb, tw, bptr_val, wp,
             *, backend="auto"):
    """Commit phase of a planned batched PUT (``kvstore.plan_put`` output),
    IN PLACE on both backends. Returns the updated (bucket_keys,
    bucket_ptr, pool): the same tensors."""
    if resolve_backend(backend, keys.device):
        return _ref.hash_put(
            bucket_keys, bucket_ptr, pool, keys, vals, tb, tw, bptr_val, wp
        )
    return _hp.insert(
        bucket_keys, bucket_ptr, pool, keys, vals, tb, tw, bptr_val, wp
    )


def tx_commit(log, store, batch, values, slot, rows, *, backend="auto"):
    """Fused ORCA-TX replica commit (``transaction.plan_commit`` output):
    write-ahead log append + store scatter, IN PLACE on both backends.
    Sentinel-targeted payloads (slot == LC, rows == NK) are zeroed.
    Returns the updated (log, store): the same tensors."""
    if resolve_backend(backend, batch.device):
        return _ref.tx_commit(log, store, batch, values, slot, rows)
    return _tc.commit(log, store, batch, values, slot, rows)


def tx_commit_chain(log, store, batch, values, slot, rows, *,
                    backend="auto"):
    """Whole-chain fused ORCA-TX commit, IN PLACE: every replica of a
    local chain in one dual scatter (``transaction.chain_commit_apply``).
    slot: (R, B) per-replica log slots; rows: (B*M,) shared or (R, B*M)
    per replica. Returns the updated (log, store): the same tensors."""
    if resolve_backend(backend, batch.device):
        return _ref.tx_commit_chain(log, store, batch, values, slot, rows)
    return _tc.commit_chain(log, store, batch, values, slot, rows)


def embedding_reduce(table, idx, seg_ids, num_segments: int, *,
                     backend="auto"):
    """Gather + segment sum: (R, D), (N,), (N,) -> (num_segments, D) f32,
    each segment added in lookup order from its first row, empty segments
    zero — the JAX package's Pallas kernel together with the zeroing its
    ``ops.embedding_reduce`` adds."""
    if resolve_backend(backend, idx.device):
        return _ref.embedding_reduce(table, idx, seg_ids, num_segments)
    return _er.embedding_reduce(table, idx, seg_ids, num_segments)


def paged_attention_stats(q, k_pages, v_pages, page_table, lengths, *,
                          backend="auto"):
    """Online-softmax stats (acc, m, l), f32, of pre-scaled q (B, KVH, G,
    hd) over the first ``lengths`` tokens of each sequence in the paged
    pool (NP, PS, KVH, hd); -1 table entries resolve to the last page, the
    zero sentinel."""
    if resolve_backend(backend, q.device):
        return _ref.paged_attention_stats(q, k_pages, v_pages, page_table,
                                          lengths)
    return _pa.paged_attention_stats(q, k_pages, v_pages, page_table,
                                     lengths)


def paged_attention(q, k_pages, v_pages, page_table, lengths, *,
                    backend="auto"):
    """Normalised paged decode attention: the stats and the final divide.
    Returns (B, KVH, G, hd) f32."""
    acc, _, l = paged_attention_stats(q, k_pages, v_pages, page_table,
                                      lengths, backend=backend)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def flash_attention(q, k, v, *, window: int = 0, backend="auto"):
    """Causal (optionally windowed) GQA attention, q (B, H, S, hd) and k/v
    (B, KVH, S, hd) -> (B, H, S, hd) in q's dtype. The CUDA kernel picks
    its own tiles and takes any S."""
    if resolve_backend(backend, q.device):
        return _ref.flash_attention(q, k, v, window=window)
    return _fa.flash_attention(q, k, v, window=window)
