"""Edge cases of the KVS PUT commit kernels (``commit_buckets``,
``write_rows``), shared by the numpy model of the CUDA kernels
(``test_torch_kvs_commit_walk.py``) and the card tests
(``test_torch_cuda.py``). Imports only numpy, the port and
``hash_probe_cases`` (for ``to_torch``).

Each case is a seeded numpy state in the sentinel-resident layout and a
planned batch: bucket_keys (NB+1, W, KW), bucket_ptr (NB+1, W), pool
(NP+1, VW), keys (B, KW), vals (B, VW), tb, tw, bptr_val and wp (B,).
Live targets are distinct, as the plan makes them. Every case starts from
sentinel rows that are NOT zero, so a sentinel word the commit should
zero, or should leave alone, shows either way; dead entries carry
non-zero payloads, so a dead entry that stored would show too.

- ``all_dead``: every entry aims at the sentinel rows, the dead ``tw``
  spread over every way (at B = 1: one dead entry);
- ``none_dead``: every entry live; the sentinel rows stay as they were
  (at B = 1: one live entry);
- ``some_dead``: about a third dead in each pass, apart, with random
  ``tw``: only the aimed-at ways of row NB become zero, all of row NP;
- ``serve_mix``: 95% dead, every dead ``tw`` 0, as ``kvstore.plan_put``
  aims them at the engine's PUT share;
- ``out_of_range``: a quarter of ``tb``, ``tw`` and ``wp`` outside the
  arrays (negative, NB + 1 or NP + 1, INT32 limits; skipped), a third
  dead, the rest live;
- ``extreme``: key words, pointers and values at the INT32 limits, -1
  and 0, a third dead.
"""
from __future__ import annotations

import numpy as np

from hash_probe_cases import to_torch  # noqa: F401 (shared with the tests)
from repro_torch.kernels import ref

CASES = ("all_dead", "none_dead", "some_dead", "serve_mix", "out_of_range",
         "extreme")
# the cases whose targets the plain versions (and the Pallas kernels) take
IN_RANGE = tuple(c for c in CASES if c != "out_of_range")
# (num_buckets, ways, key_words, pool_size, val_words): the serve widths
# (W 8, KW 2, VW 16) first, then the widths beside them; W 40 has more
# ways than a warp has lanes, VW 33 and 132 rows wider than 32 chunks
SHAPES = [(64, 8, 2, 400, 16), (200, 2, 1, 400, 1), (100, 4, 3, 400, 3),
          (32, 16, 2, 400, 8), (16, 32, 1, 400, 17), (16, 32, 3, 400, 33),
          (8, 40, 2, 400, 132)]
BATCHES = [1, 37, 300]
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
EXTREMES = np.array([INT32_MIN, INT32_MAX, -1, 0], np.int64)


def _i32(x):
    return np.asarray(x).astype(np.int32)


def _bad(rng, n, limit):
    """``n`` targets outside [0, limit]."""
    return rng.choice(np.array([-1, -7, limit + 1, limit + 5, INT32_MAX,
                                INT32_MIN], np.int64), n)


def commit_case(name: str, seed: int, nb: int, w: int, kw: int, np_: int,
                vw: int, b: int) -> dict:
    """numpy int32 arrays of a planned commit for case ``name`` (b <=
    nb * w and b <= np_, so live targets can be distinct)."""
    assert b <= nb * w and b <= np_
    rng = np.random.default_rng(seed)
    bk = _i32(rng.integers(-99, 99, (nb + 1, w, kw)))
    bp = _i32(rng.integers(-1, np_, (nb + 1, w)))
    pool = _i32(rng.integers(-999, 999, (np_ + 1, vw)))
    bk[nb] = rng.integers(1, 99, (w, kw))
    bp[nb] = rng.integers(1, 99, w)
    pool[np_] = rng.integers(1, 99, vw)
    keys = rng.integers(-999, 999, (b, kw))
    vals = rng.integers(-999, 999, (b, vw))
    bptr_val = rng.integers(0, np_, b)
    slots = rng.permutation(nb * w)[:b]
    tb, tw = slots // w, slots % w
    wp = rng.permutation(np_)[:b]
    share = {"all_dead": 1.0, "none_dead": 0.0, "serve_mix": 0.95}.get(
        name, 1 / 3)
    dead_b = rng.random(b) < share
    dead_p = rng.random(b) < share
    if name == "all_dead":
        dead_b[:] = dead_p[:] = True
        tw = rng.permutation(np.arange(b) % w)  # every way, where b >= w
    tb = np.where(dead_b, nb, tb)
    if name == "serve_mix":
        tw = np.where(dead_b, 0, tw)
    wp = np.where(dead_p, np_, wp)
    if name == "out_of_range":
        for arr, limit in ((tb, nb), (wp, np_)):
            bad = rng.random(b) < 0.25
            arr[bad] = _bad(rng, int(bad.sum()), limit)
        bad = rng.random(b) < 0.25
        tw[bad] = _bad(rng, int(bad.sum()), w - 1)
    elif name == "extreme":
        keys = rng.choice(EXTREMES, (b, kw))
        vals = rng.choice(EXTREMES, (b, vw))
        bptr_val = rng.choice(EXTREMES, b)
    elif name not in CASES:
        raise ValueError(name)
    return {"bucket_keys": bk, "bucket_ptr": bp, "pool": pool,
            "keys": _i32(keys), "vals": _i32(vals), "tb": _i32(tb),
            "tw": _i32(tw), "bptr_val": _i32(bptr_val), "wp": _i32(wp)}


def plain_commit(bucket_keys, bucket_ptr, pool, keys, vals, tb, tw, bptr_val,
                 wp):
    """The plain versions (``ref.commit_buckets``, ``ref.write_rows``) on
    the entries whose targets lie in the arrays, IN PLACE: what the CUDA
    kernels compute for any targets. Returns (bucket_keys, bucket_ptr,
    pool)."""
    nb, w = bucket_ptr.shape[0] - 1, bucket_ptr.shape[1]
    np_ = pool.shape[0] - 1
    kb = (tb >= 0) & (tb <= nb) & (tw >= 0) & (tw < w)
    kp = (wp >= 0) & (wp <= np_)
    ref.commit_buckets(bucket_keys, bucket_ptr, keys[kb], tb[kb], tw[kb],
                       bptr_val[kb])
    ref.write_rows(pool, vals[kp], wp[kp])
    return bucket_keys, bucket_ptr, pool
