"""Wrappers of the CUDA hash-table kernels (``csrc/hash_probe.cu``).

The APU's data-structure walker does three dependent memory accesses per
GET (primary bucket, overflow bucket, value row) and four per PUT:

  ``probe``          buckets in, found flag + pool pointer out
  ``fetch``          value rows gathered at the resolved pointers
  ``get_walk``       both in one launch: the GET walk of the main path
  ``cache_probe``    hot-set cache set lookup (before the bucket walk)
  ``commit_buckets`` PUT scatter pass 1: the chosen way of each bucket
  ``write_rows``     PUT scatter pass 2: value rows into the pool

``get`` launches ``get_walk``, ``insert`` the two scatter passes;
``probe`` alone is the PUT plan's existence check, and ``fetch``, the
port of its own TPU kernel, runs on no main path. The wrappers follow
``_launch`` (CUDA tensors only, checked, launched on the current stream);
the commit wrappers update the state arrays IN PLACE, like the TPU
kernels' ``input_output_aliases``. ``launches`` counts each kernel's
launches since the last :func:`reset_launches`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._launch import LL, I, P, Library, check as _check
from repro_torch.kernels._launch import same as _same

I32 = torch.int32
KERNELS = ("probe", "fetch", "get_walk", "cache_probe", "commit_buckets",
           "write_rows")
_lib = Library("hash_probe", KERNELS, {
    "orca_probe": [P] * 7 + [LL, LL, I, I],
    "orca_fetch": [P] * 3 + [LL, LL, I],
    "orca_get": [P] * 8 + [LL, LL, LL, I, I, I],
    "orca_cache_probe": [P] * 8 + [LL, LL, I, I, I],
    "orca_commit_buckets": [P] * 6 + [LL, LL, I, I],
    "orca_write_rows": [P] * 3 + [LL, LL, I],
})
launches = _lib.launches
reset_launches = _lib.reset
_launch = _lib.launch


def probe(bucket_keys, bucket_ptr, keys, h1, h2):
    """bucket_keys: (NB + 1, W, KW); bucket_ptr: (NB + 1, W) — the
    sentinel-resident layout; keys: (B, KW); h1/h2: (B,) bucket ids in
    [0, NB]. Returns (found (B,) bool, ptr (B,) int32; ptr 0 on a miss)."""
    dev = keys.device
    _check("keys", keys, 2, dev)
    b, kw = keys.shape
    _check("bucket_keys", bucket_keys, 3, dev)
    rows, w = bucket_keys.shape[:2]
    _same("bucket_keys", bucket_keys.shape, (rows, w, kw))
    _check("bucket_ptr", bucket_ptr, 2, dev)
    _same("bucket_ptr", bucket_ptr.shape, (rows, w))
    for name, t in (("h1", h1), ("h2", h2)):
        _check(name, t, 1, dev)
        _same(name, t.shape, (b,))
    found = torch.empty((b,), dtype=torch.bool, device=dev)
    ptr = torch.empty((b,), dtype=I32, device=dev)
    _launch("probe", "orca_probe", dev, bucket_keys.data_ptr(),
            bucket_ptr.data_ptr(), keys.data_ptr(), h1.data_ptr(),
            h2.data_ptr(), found.data_ptr(), ptr.data_ptr(), b, rows, w, kw)
    return found, ptr


def fetch(pool, ptr):
    """pool: (NP + 1, VW), row NP = the zero sentinel; ptr: (B,) int32 in
    [0, NP] (misses pre-clamped to NP). Returns (B, VW)."""
    dev = ptr.device
    _check("ptr", ptr, 1, dev)
    _check("pool", pool, 2, dev)
    b = ptr.shape[0]
    rows, vw = pool.shape
    out = torch.empty((b, vw), dtype=I32, device=dev)
    _launch("fetch", "orca_fetch", dev, pool.data_ptr(), ptr.data_ptr(),
            out.data_ptr(), b, rows, vw)
    return out


def cache_probe(cache_keys, cache_vals, cache_meta, keys, cset):
    """cache_keys: (CS + 1, CW, KW); cache_vals: (CS + 1, CW, VW);
    cache_meta: (CS + 1, CW); keys: (B, KW); cset: (B,) set ids in [0, CS].
    Returns (hit (B,) bool, way (B,) int32, vals (B, VW)) — the max
    matching way and its value line, zeros where missed."""
    dev = keys.device
    _check("keys", keys, 2, dev)
    b, kw = keys.shape
    _check("cache_keys", cache_keys, 3, dev)
    sets, cw = cache_keys.shape[:2]
    _same("cache_keys", cache_keys.shape, (sets, cw, kw))
    _check("cache_vals", cache_vals, 3, dev)
    vw = cache_vals.shape[2]
    _same("cache_vals", cache_vals.shape, (sets, cw, vw))
    _check("cache_meta", cache_meta, 2, dev)
    _same("cache_meta", cache_meta.shape, (sets, cw))
    _check("cset", cset, 1, dev)
    _same("cset", cset.shape, (b,))
    hit = torch.empty((b,), dtype=torch.bool, device=dev)
    way = torch.empty((b,), dtype=I32, device=dev)
    vals = torch.empty((b, vw), dtype=I32, device=dev)
    _launch("cache_probe", "orca_cache_probe", dev, cache_keys.data_ptr(),
            cache_vals.data_ptr(), cache_meta.data_ptr(), keys.data_ptr(),
            cset.data_ptr(), hit.data_ptr(), way.data_ptr(), vals.data_ptr(),
            b, sets, cw, kw, vw)
    return hit, way, vals


def commit_buckets(bucket_keys, bucket_ptr, keys, tb, tw, bptr_val):
    """Scatter pass 1, IN PLACE: way ``tw[i]`` of bucket row ``tb[i]`` <-
    (keys[i], bptr_val[i]); way ``tw[i]`` of the resident sentinel row
    (tb == NB) becomes zero, the sentinel's other ways keep their words.
    Live (tb, tw) must be unique, as the plan makes them; entries outside
    the arrays are skipped. Returns (bucket_keys, bucket_ptr), the same
    tensors."""
    dev = keys.device
    _check("keys", keys, 2, dev)
    b, kw = keys.shape
    _check("bucket_keys", bucket_keys, 3, dev)
    rows, w = bucket_keys.shape[:2]
    _same("bucket_keys", bucket_keys.shape, (rows, w, kw))
    _check("bucket_ptr", bucket_ptr, 2, dev)
    _same("bucket_ptr", bucket_ptr.shape, (rows, w))
    for name, t in (("tb", tb), ("tw", tw), ("bptr_val", bptr_val)):
        _check(name, t, 1, dev)
        _same(name, t.shape, (b,))
    _launch("commit_buckets", "orca_commit_buckets", dev,
            bucket_keys.data_ptr(), bucket_ptr.data_ptr(), keys.data_ptr(),
            tb.data_ptr(), tw.data_ptr(), bptr_val.data_ptr(), b, rows - 1,
            w, kw)
    return bucket_keys, bucket_ptr


def write_rows(pool, vals, wp):
    """Scatter pass 2, IN PLACE: pool row ``wp[i]`` <- vals[i]; the
    resident sentinel row NP becomes zero where some wp aims at it. Live
    wp must be unique; wp outside the pool is skipped. Returns the pool,
    the same tensor."""
    dev = vals.device
    _check("vals", vals, 2, dev)
    b, vw = vals.shape
    _check("pool", pool, 2, dev)
    _same("pool", pool.shape[1:], (vw,))
    _check("wp", wp, 1, dev)
    _same("wp", wp.shape, (b,))
    _launch("write_rows", "orca_write_rows", dev, pool.data_ptr(),
            vals.data_ptr(), wp.data_ptr(), b, pool.shape[0] - 1, vw)
    return pool


def get(bucket_keys, bucket_ptr, pool, keys, h1, h2):
    """Full GET walk in one launch (``get_walk``): probe, then the pool row
    at the resolved pointer clamped to NP. Returns (vals (B, VW), found
    (B,)); misses are zero and read no row. Ids outside [0, NB] match
    nothing."""
    dev = keys.device
    _check("keys", keys, 2, dev)
    b, kw = keys.shape
    _check("bucket_keys", bucket_keys, 3, dev)
    rows, w = bucket_keys.shape[:2]
    _same("bucket_keys", bucket_keys.shape, (rows, w, kw))
    _check("bucket_ptr", bucket_ptr, 2, dev)
    _same("bucket_ptr", bucket_ptr.shape, (rows, w))
    _check("pool", pool, 2, dev)
    for name, t in (("h1", h1), ("h2", h2)):
        _check(name, t, 1, dev)
        _same(name, t.shape, (b,))
    pool_rows, vw = pool.shape
    vals = torch.empty((b, vw), dtype=I32, device=dev)
    found = torch.empty((b,), dtype=torch.bool, device=dev)
    _launch("get_walk", "orca_get", dev, bucket_keys.data_ptr(),
            bucket_ptr.data_ptr(), pool.data_ptr(), keys.data_ptr(),
            h1.data_ptr(), h2.data_ptr(), vals.data_ptr(), found.data_ptr(),
            b, rows, pool_rows, w, kw, vw)
    return vals, found


def insert(bucket_keys, bucket_ptr, pool, keys, vals, tb, tw, bptr_val, wp):
    """Full planned PUT commit (see ``kvstore.plan_put`` for the plan), IN
    PLACE: both scatter passes. Returns (bucket_keys, bucket_ptr, pool)."""
    commit_buckets(bucket_keys, bucket_ptr, keys, tb, tw, bptr_val)
    write_rows(pool, vals, wp)
    return bucket_keys, bucket_ptr, pool
