"""Edge cases of the KVS lookup kernels (``probe``, ``cache_probe``),
shared by the numpy model of the CUDA kernels
(``test_torch_hash_probe_walk.py``) and the card tests
(``test_torch_cuda.py``). Imports only numpy, torch and the port.

Each case is a seeded numpy state and batch in the sentinel-resident
layout (the last bucket row and cache set all zero). ``probe_case``:

- ``random``: small key words (repeats, zeros, negatives), about half the
  queries aimed at a live way of their h1 or h2;
- ``max_pointer``: two ways of the query's h1 bucket hold its key, both
  live (the larger pointer wins);
- ``both_buckets``: the key in h1 and in h2, h2's pointer the larger (h1
  wins all the same);
- ``negative_pointer``: a way holds the key with a pointer < 0 (no match),
  in half the buckets beside a live way holding it too;
- ``zero_key``: all-zero queries, h1 often the sentinel row NB (all zero,
  so its ways match with pointer 0) and empty ways holding key 0;
- ``same_bucket``: h1 == h2;
- ``sentinel_ids``: h1, h2 or both at NB;
- ``out_of_range``: ids outside [0, NB] (negative, NB + 1, INT32 limits):
  they match nothing and read nothing;
- ``all_miss`` / ``all_hit``: no query / every query held by a live way.

``get_case`` adds a pool (NP + 1, VW) to a probe case, its live
pointers mapped into [0, NP) in order (the larger pointer still wins),
and three cases of the GET walk:

- ``overflow_only``: every query held only by its h2 bucket;
- ``retargeted``: about half the rows aimed at the sentinel bucket (h1 =
  h2 = NB), as ``kvstore.get`` aims its cache hits;
- ``ptr_above_np``: pointers up to 2 NP, so about half the hits point
  at or past the sentinel row, which is not zero here: a found pointer
  reads row min(ptr, NP).

``cache_case`` has the same shapes of case for a set-associative cache,
keys distinct within a set except in ``max_way`` (two live ways hold the
key: the larger way wins) and ``meta_zero`` (a way with meta 0 holds the
key: it never hits, a live lower way does).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref

PROBE_CASES = ("random", "max_pointer", "both_buckets", "negative_pointer",
               "zero_key", "same_bucket", "sentinel_ids", "out_of_range",
               "all_miss", "all_hit")
CACHE_CASES = ("random", "max_way", "meta_zero", "zero_key", "sentinel_ids",
               "out_of_range", "all_miss", "all_hit")
# the cases whose ids the plain versions (and the Pallas kernels) take
PROBE_IN_RANGE = tuple(c for c in PROBE_CASES if c != "out_of_range")
# the Pallas cache kernel sums the lines of the matching ways (kvstore
# admits a key once per set), so it agrees only where one way matches
CACHE_PALLAS = tuple(c for c in CACHE_CASES
                     if c not in ("out_of_range", "max_way"))
# (num_buckets, ways, key_words, pool_size, val_words): the card tests'
# shapes (ways > 32 included, so a warp loops)
SHAPES = [(8, 2, 2, 24, 4), (32, 4, 2, 64, 16), (64, 40, 3, 300, 33)]
GET_CASES = PROBE_CASES + ("overflow_only", "retargeted", "ptr_above_np")
GET_IN_RANGE = tuple(c for c in GET_CASES if c != "out_of_range")
# the lookups' shapes: the serve widths (kvstore's in chip_smoke.py: 8
# ways, 4 cache ways, 2 key words, 16 value words) on 16 rows, then SHAPES
PROBE_SHAPES = [(16, 8, 2)] + [(n, w, kw) for n, w, kw, _, _ in SHAPES]
# the GET walk's: the serve widths (8 ways, 2 key words, 16 value words)
# on 16 buckets, then SHAPES
GET_SHAPES = [(16, 8, 2, 1000, 16)] + SHAPES
CACHE_SHAPES = [(16, 4, 2, 16)] + [(n, w, kw, vw)
                                   for n, w, kw, _, vw in SHAPES]
OUT_OF_RANGE = np.array([-1, -7, 2**31 - 1, -2**31], np.int64)
LO, HI = -2, 4  # random key words: repeats, zeros and negatives


def _i32(x):
    return np.asarray(x).astype(np.int32)


def _own_keys(n, kw):
    """(n, kw) keys no random word equals: key u is (100 + u, -100 - u,
    ...)."""
    u = np.arange(n)[:, None]
    j = np.arange(kw)[None, :]
    return _i32(np.where(j % 2 == 0, 100 + u + j, -100 - u - j))


def _replace(ids, mask, values):
    """``ids`` with ``values`` (int64, of the same length) where
    ``mask``."""
    return _i32(np.where(mask, values, ids.astype(np.int64)))


def probe_case(name: str, seed: int, nb: int, w: int, kw: int,
               b: int) -> dict:
    """numpy int32 bucket_keys (nb+1, w, kw), bucket_ptr (nb+1, w), keys
    (b, kw), h1 and h2 (b,) for case ``name`` (w >= 2)."""
    rng = np.random.default_rng(seed)
    bk = _i32(rng.integers(LO, HI, (nb + 1, w, kw)))
    bp = _i32(rng.integers(0, 1000, (nb + 1, w)))
    bp[rng.random((nb + 1, w)) < 0.3] = -1
    keys = _i32(rng.integers(LO, HI, (b, kw)))
    h1 = _i32(rng.integers(0, nb, b))
    h2 = _i32(rng.integers(0, nb, b))
    u = np.arange(b) % nb  # a bucket of its own a request (mod nb)
    own = _own_keys(nb, kw)
    if name in ("random", "same_bucket", "out_of_range", "all_hit"):
        live = np.argwhere(bp[:nb] >= 0)
        share = 1.0 if name == "all_hit" else 0.5
        for i in np.flatnonzero(rng.random(b) < share):
            bucket, way = live[rng.integers(len(live))]
            keys[i] = bk[bucket, way]
            (h1 if rng.random() < 0.5 else h2)[i] = bucket
        if name == "same_bucket":
            h2 = h1.copy()
        elif name == "out_of_range":
            bad = np.append(OUT_OF_RANGE, [nb + 1, nb + 5])
            h1 = _replace(h1, rng.random(b) < 1 / 3, rng.choice(bad, b))
            h2 = _replace(h2, rng.random(b) < 1 / 3, rng.choice(bad, b))
    elif name == "max_pointer":
        a, c = rng.integers(0, w, nb), rng.integers(0, w - 1, nb)
        c = np.where(c >= a, c + 1, c)  # a != c
        bk[np.arange(nb), a], bk[np.arange(nb), c] = own, own
        bp[np.arange(nb), a] = rng.integers(0, 500, nb)
        bp[np.arange(nb), c] = rng.integers(500, 1000, nb)
        keys, h1 = own[u], _i32(u)
    elif name == "both_buckets":
        rows = np.arange(nb)
        nxt = (rows + 1) % nb
        bk[rows, 0], bp[rows, 0] = own, rng.integers(0, 500, nb)
        bk[nxt, w - 1], bp[nxt, w - 1] = own, rng.integers(500, 1000, nb)
        keys, h1, h2 = own[u], _i32(u), _i32(nxt[u])
    elif name == "negative_pointer":
        a = rng.integers(0, w - 1, nb)
        bk[np.arange(nb), a] = own
        bp[np.arange(nb), a] = rng.choice([-1, -5, -2**31], nb)
        also = np.arange(0, nb, 2)  # every other bucket
        bk[also, w - 1], bp[also, w - 1] = own[also], 7
        keys, h1 = own[u], _i32(u)
    elif name == "zero_key":
        keys[:] = 0
        h1 = _i32(np.where(rng.random(b) < 0.5, nb, h1))
        empty = rng.random((nb, w)) < 0.3
        bk[:nb][empty] = 0  # empty ways (ptr -1) holding key 0,
        bp[:nb][empty] = -1
        bk[nb // 2, 1], bp[nb // 2, 1] = 0, 3  # and one live zero key
    elif name == "sentinel_ids":
        pick = rng.integers(0, 3, b)
        h1 = _i32(np.where(pick != 1, nb, h1))
        h2 = _i32(np.where(pick != 0, nb, h2))
    elif name == "all_miss":
        keys = _i32(rng.integers(50, 60, (b, kw)))
    else:
        raise ValueError(name)
    bk[nb], bp[nb] = 0, 0
    return {"bucket_keys": bk, "bucket_ptr": bp, "keys": keys, "h1": h1,
            "h2": h2}


def get_case(name: str, seed: int, nb: int, w: int, kw: int, np_: int,
             vw: int, b: int) -> dict:
    """``probe_case``'s arrays for case ``name`` (a probe case, or one of
    the GET walk's own) and a pool (np_ + 1, vw), row np_ the sentinel:
    zero, except in ``ptr_above_np``."""
    base = {"overflow_only": "all_miss", "retargeted": "random",
            "ptr_above_np": "all_hit"}.get(name, name)
    c = probe_case(base, seed, nb, w, kw, b)
    rng = np.random.default_rng(seed + 1)
    bk, bp = c["bucket_keys"], c["bucket_ptr"]
    if name == "overflow_only":
        rows = np.arange(nb)
        nxt = (rows + 1) % nb
        own = _own_keys(nb, kw)
        bk[nxt, w - 1], bp[nxt, w - 1] = own, rng.integers(0, 1000, nb)
        u = np.arange(b) % nb
        c.update(keys=own[u], h1=_i32(u), h2=_i32(nxt[u]))
    elif name == "retargeted":
        aim = rng.random(b) < 0.5
        c["h1"] = _i32(np.where(aim, nb, c["h1"]))
        c["h2"] = _i32(np.where(aim, nb, c["h2"]))
    span = 2 * np_ if name == "ptr_above_np" else np_
    live = bp[:nb] >= 0  # probe_case's pointers lie in [0, 1000)
    bp[:nb] = np.where(live, bp[:nb].astype(np.int64) * span // 1000,
                       bp[:nb])
    pool = _i32(rng.integers(-1000, 1000, (np_ + 1, vw)))
    if name != "ptr_above_np":
        pool[np_] = 0
    c["pool"] = pool
    return c


def cache_case(name: str, seed: int, cs: int, cw: int, kw: int, vw: int,
               b: int) -> dict:
    """numpy int32 cache_keys (cs+1, cw, kw), cache_vals (cs+1, cw, vw),
    cache_meta (cs+1, cw), keys (b, kw) and cset (b,) for case ``name``
    (cw >= 2, (HI - LO) ** kw >= cw)."""
    rng = np.random.default_rng(seed)
    span = HI - LO
    ck = np.zeros((cs + 1, cw, kw), np.int32)
    for s in range(cs):  # keys distinct within a set
        codes = rng.choice(span ** kw, size=cw, replace=False)
        for j in range(kw):
            ck[s, :, j] = (codes // span ** j) % span + LO
    cv = _i32(rng.integers(-1000, 1000, (cs + 1, cw, vw)))
    cm = _i32(rng.integers(1, 17, (cs + 1, cw)))
    cm[rng.random((cs + 1, cw)) < 0.3] = 0
    keys = _i32(rng.integers(LO, HI, (b, kw)))
    cset = _i32(rng.integers(0, cs, b))
    u = np.arange(b) % cs
    own = _own_keys(cs, kw)
    if name in ("random", "out_of_range", "all_hit"):
        live = np.argwhere(cm[:cs] > 0)
        share = 1.0 if name == "all_hit" else 0.5
        for i in np.flatnonzero(rng.random(b) < share):
            s, way = live[rng.integers(len(live))]
            keys[i], cset[i] = ck[s, way], s
        if name == "out_of_range":
            bad = np.append(OUT_OF_RANGE, [cs + 1, cs + 5])
            cset = _replace(cset, rng.random(b) < 1 / 3, rng.choice(bad, b))
    elif name in ("max_way", "meta_zero"):
        a = rng.integers(0, cw - 1, cs)
        c = rng.integers(a + 1, cw)  # a < c
        rows = np.arange(cs)
        ck[rows, a], ck[rows, c] = own, own
        cm[rows, a] = rng.integers(1, 17, cs)
        if name == "max_way":
            cm[rows, c] = rng.integers(1, 17, cs)
        else:  # the larger way empty; the lower one live in half the sets
            cm[rows, c] = 0
            cm[rows[1::2], a[1::2]] = 0  # every other set
        keys, cset = own[u], _i32(u)
    elif name == "zero_key":
        keys[:] = 0
        cset = _i32(np.where(rng.random(b) < 0.5, cs, cset))
        empty = rng.random((cs, cw)) < 0.5
        ck[:cs][empty] = 0  # empty ways (meta 0) holding key 0
        cm[:cs][empty] = 0
    elif name == "sentinel_ids":
        cset[:] = cs
    elif name == "all_miss":
        keys = _i32(rng.integers(50, 60, (b, kw)))
    else:
        raise ValueError(name)
    ck[cs], cv[cs], cm[cs] = 0, 0, 0
    return {"cache_keys": ck, "cache_vals": cv, "cache_meta": cm,
            "keys": keys, "cset": cset}


def to_torch(case: dict, device="cpu") -> dict:
    """Copies of a case's arrays as tensors on ``device``."""
    return {k: torch.tensor(v, device=device) for k, v in case.items()}


def _in_range(ids, limit):
    """``ids`` with every id outside [0, limit) sent to ``limit``, the row
    the callers append that matches nothing."""
    ok = (ids >= 0) & (ids < limit)
    return torch.where(ok, ids, limit).to(torch.int32)


def plain_probe(bucket_keys, bucket_ptr, keys, h1, h2):
    """``ref.hash_probe`` with ids outside [0, NB] matching nothing: what
    the CUDA kernel computes for any ids. The ids are sent to one more
    bucket row whose pointers are all -1."""
    rows = bucket_keys.shape[0]
    bk = torch.cat([bucket_keys, torch.zeros_like(bucket_keys[:1])])
    bp = torch.cat([bucket_ptr, torch.full_like(bucket_ptr[:1], -1)])
    return ref.hash_probe(bk, bp, keys, _in_range(h1, rows),
                          _in_range(h2, rows))


def plain_get(bucket_keys, bucket_ptr, pool, keys, h1, h2):
    """``ref.hash_get`` with ids outside [0, NB] matching nothing, as in
    :func:`plain_probe`. Returns (vals, found)."""
    rows = bucket_keys.shape[0]
    bk = torch.cat([bucket_keys, torch.zeros_like(bucket_keys[:1])])
    bp = torch.cat([bucket_ptr, torch.full_like(bucket_ptr[:1], -1)])
    return ref.hash_get(bk, bp, pool, keys, _in_range(h1, rows),
                        _in_range(h2, rows))


def plain_cache_probe(cache_keys, cache_vals, cache_meta, keys, cset):
    """``ref.cache_probe`` with set ids outside [0, CS] hitting nothing:
    they are sent to one more set whose meta is all 0."""
    sets = cache_keys.shape[0]
    return ref.cache_probe(
        torch.cat([cache_keys, torch.zeros_like(cache_keys[:1])]),
        torch.cat([cache_vals, torch.zeros_like(cache_vals[:1])]),
        torch.cat([cache_meta, torch.zeros_like(cache_meta[:1])]),
        keys, _in_range(cset, sets))
