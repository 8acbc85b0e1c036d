"""The CUDA kernels of the PyTorch port against their plain versions, on a
card. These need an NVIDIA GPU and nvcc, skip without them, and import
nothing of JAX, so they run where the port runs:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import engine as eng
from repro_torch.core import kvstore as kv
from repro_torch.kernels import hash_probe as hp
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda

# (num_buckets, ways, key_words, pool_size, val_words)
SHAPES = [(8, 2, 2, 24, 4), (32, 4, 2, 64, 16), (64, 40, 3, 300, 33)]
BATCHES = [1, 7, 32, 300]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _i32(rng, lo, hi, shape):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))


def _same(want, got, what):
    a, b = interop.to_numpy(want), interop.to_numpy(got)
    for x, y in zip(a if isinstance(a, list) else [a],
                    b if isinstance(b, list) else [b]):
        assert x.dtype == y.dtype and np.array_equal(x, y), what


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", BATCHES)
def test_kernels_match_plain_versions(dev, shape, b):
    """Random sentinel-resident states (ways > 32 included, so a warp
    loops), queries that hit and miss, sentinel-aimed commits."""
    nb, w, kw, np_, vw = shape
    rng = np.random.default_rng(nb + w + b)
    bk = _i32(rng, -2, 4, (nb + 1, w, kw))
    bp = _i32(rng, -1, np_, (nb + 1, w))
    bk[nb], bp[nb] = 0, 0
    pool = _i32(rng, -999, 999, (np_ + 1, vw))
    pool[np_] = 0
    keys = _i32(rng, -2, 4, (b, kw))
    h1 = _i32(rng, 0, nb + 1, (b,))
    h2 = _i32(rng, 0, nb, (b,))
    d = lambda x: x.to(dev)  # noqa: E731
    _same(ref.hash_probe(bk, bp, keys, h1, h2),
          hp.probe(d(bk), d(bp), d(keys), d(h1), d(h2)), "probe")
    ptr = _i32(rng, 0, np_ + 1, (b,))
    _same(ref.fetch(pool, ptr), hp.fetch(d(pool), d(ptr)), "fetch")
    _same(ref.hash_get(bk, bp, pool, keys, h1, h2),
          hp.get(d(bk), d(bp), d(pool), d(keys), d(h1), d(h2)), "get")
    cv = _i32(rng, -999, 999, (nb + 1, w, vw))
    cm = _i32(rng, 0, 3, (nb + 1, w))
    cv[nb], cm[nb] = 0, 0
    cset = _i32(rng, 0, nb + 1, (b,))
    _same(ref.cache_probe(bk, cv, cm, keys, cset),
          hp.cache_probe(d(bk), d(cv), d(cm), d(keys), d(cset)),
          "cache_probe")
    # unique live targets, the rest aimed at the sentinel rows
    pairs = torch.from_numpy(rng.permutation(nb * w)[:b].astype(np.int32))
    n = pairs.shape[0]
    tb = torch.full((b,), nb, dtype=torch.int32)
    tw = _i32(rng, 0, w, (b,))
    live = torch.from_numpy(rng.random(n) < 0.7)
    tb[:n] = torch.where(live, pairs // w, nb)
    tw[:n] = torch.where(live, pairs % w, tw[:n])
    rows = torch.from_numpy(rng.permutation(np_)[:b].astype(np.int32))
    wp = torch.full((b,), np_, dtype=torch.int32)
    wp[: rows.shape[0]] = rows
    vals = _i32(rng, -999, 999, (b, vw))
    bptr_val = _i32(rng, 0, np_, (b,))
    want = ref.hash_put(bk.clone(), bp.clone(), pool.clone(), keys, vals, tb,
                        tw, bptr_val, wp)
    got = hp.insert(d(bk), d(bp), d(pool), d(keys), d(vals), d(tb), d(tw),
                    d(bptr_val), d(wp))
    torch.cuda.synchronize()
    _same(want, got, "insert")


def test_wrappers_reject_bad_tensors(dev):
    bk = torch.zeros((5, 2, 2), dtype=torch.int32, device=dev)
    bp = torch.zeros((5, 2), dtype=torch.int32, device=dev)
    keys = torch.zeros((3, 2), dtype=torch.int32, device=dev)
    h = torch.zeros((3,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        hp.probe(bk, bp, keys.to(torch.int64), h, h)
    with pytest.raises(ValueError, match="contiguous"):
        hp.probe(bk, bp, torch.zeros((2, 3), dtype=torch.int32,
                                     device=dev).t(), h, h)
    with pytest.raises(ValueError, match="shape"):
        hp.probe(bk, bp, keys, h[:2], h)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hp.probe(bk.cpu(), bp.cpu(), keys.cpu(), h.cpu(), h.cpu())


@pytest.mark.parametrize("cache_sets", [0, 16])
def test_engine_kvs_kernels_equal_plain_on_the_card(dev, cache_sets):
    """The same seeded traffic through an ``auto`` (kernel) and a ``ref``
    (plain) engine on the card: equal responses and final states, and
    every kernel of the path launched."""
    cfg = kv.KVConfig(num_buckets=64, ways=4, key_words=2, val_words=8,
                      pool_size=200, cache_sets=cache_sets, cache_ways=2)
    w = kv.request_words(cfg)
    runs = {}
    for backend in ("auto", "ref"):
        ecfg = eng.EngineConfig(num_queues=4, capacity=16, req_words=w,
                                resp_words=w, budget=16,
                                kernel_backend=backend)
        state = eng.make(ecfg, kv.make(cfg, device=dev))
        app = eng.bind_app(kv.app_step, cfg, ecfg)
        rng = np.random.default_rng(3)
        hp.reset_launches()
        out = []
        for _ in range(12):
            pl = np.zeros((4, w), np.int32)
            pl[:, 0] = rng.integers(1, 3, 4)
            pl[:, 1:3] = rng.integers(0, 6, (4, 2))
            pl[:, 3:] = rng.integers(-99, 99, (4, w - 3))
            state = eng.inject(state, torch.arange(4), torch.from_numpy(pl))
            state, stats = eng.run_steps(state, app, ecfg, 2)
            pay, counts, state = eng.drain_responses(state, 16)
            out.append((stats, pay, counts))
        torch.cuda.synchronize()
        runs[backend] = (interop.to_numpy((state, out)), dict(hp.launches))
    (a, launches), (b, plain_launches) = runs["auto"], runs["ref"]
    def flat(x):
        if isinstance(x, dict):
            x = list(x.values())
        return [y for v in x for y in flat(v)] if isinstance(x, list) else [x]

    for x, y in zip(flat(a), flat(b), strict=True):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    want = {"probe", "fetch", "commit_buckets", "write_rows"}
    if cache_sets:
        want.add("cache_probe")
    assert all(launches[k] > 0 for k in want), launches
    assert not any(plain_launches.values())
