"""The PyTorch port's KVS against the JAX package's (``backend="ref"``), bit
for bit: hashing, GET with and without the hot-set cache tier, the PUT
plan (every ``PutPlan`` field of the port; the JAX plan's target sort
orders feed only its TPU commit), the commit, and the engine hook, over
seeded batches with in-batch duplicates, masked rows sharing a key with a
live PUT, spills, drops, pool exhaustion and MALFORMED opcodes."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvstore as jkv
from repro_torch import interop
from repro_torch.core import kvstore as tkv
from repro_torch.core import status as tst
from torch_port_helpers import assert_same, t

# tiny configs: 8 buckets x 2 ways and a 24-row pool force spills, drops
# and pool exhaustion; the cached one has 3 sets (not a power of two) of 2
# ways, which forces CLOCK decay and eviction
CONFIGS = {
    "nocache": dict(num_buckets=8, ways=2, key_words=2, val_words=4,
                    pool_size=24),
    "cache": dict(num_buckets=8, ways=2, key_words=2, val_words=4,
                  pool_size=24, cache_sets=3, cache_ways=2),
    "wide": dict(num_buckets=12, ways=4, key_words=3, val_words=2,
                 pool_size=64, cache_sets=5, cache_ways=3),
}


def _pair(name):
    jcfg = jkv.KVConfig(**CONFIGS[name])
    return jcfg, tkv.KVConfig(**CONFIGS[name])


def _batch(rng, b, kcfg, hot):
    """Ops, keys (few distinct, so duplicates and re-reads are common) and
    values; a few opcodes are invalid."""
    op = rng.choice([0, 1, 2, 7], size=b, p=[0.1, 0.45, 0.4, 0.05])
    keys = rng.integers(-2, hot - 2, (b, kcfg.key_words))
    vals = rng.integers(-999, 999, (b, kcfg.val_words))
    pl = np.concatenate([op[:, None], keys, vals], axis=1).astype(np.int32)
    valid = rng.random(b) < 0.9
    return pl, valid


@pytest.mark.parametrize("nb,salt", [(8, 0), (7, 0x9E3779B9),
                                     (816, tkv.CACHE_SALT), (1 << 20, 0)])
def test_hash_keys_matches_jax(nb, salt):
    rng = np.random.default_rng(nb)
    keys = rng.integers(-2**31, 2**31 - 1, (64, 3), dtype=np.int64)
    keys = keys.astype(np.int32)
    keys[:4] = [[-1, -1, -1], [0, 0, 0], [-2**31, 2**31 - 1, 5], [1, -7, 0]]
    assert_same(jkv.hash_keys(jnp.asarray(keys), nb, salt),
                tkv.hash_keys(t(keys), nb, salt))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kvs_batches_match_jax(name):
    jcfg, tcfg = _pair(name)
    w = jkv.request_words(jcfg)
    assert tkv.request_words(tcfg) == w
    js = jkv.make(jcfg)
    ts = tkv.make(tcfg, device="cpu")
    assert_same(js, ts, "make")
    get = jax.jit(functools.partial(jkv.get, backend="ref", with_state=True))
    get_plain = jax.jit(functools.partial(jkv.get, backend="ref"))
    plan = jax.jit(functools.partial(jkv.plan_put, backend="ref"))
    put = jax.jit(functools.partial(jkv.put, backend="ref"))
    step = jax.jit(functools.partial(jkv.app_step, cfg=jcfg,
                                     kernel_backend="ref"))
    rng = np.random.default_rng(len(name))
    kw, vw = jcfg.key_words, jcfg.val_words
    for it in range(14):
        pl, valid = _batch(rng, 8, jcfg, hot=4 if it < 7 else 9)
        keys = pl[:, 1: 1 + kw]
        mask = valid & (pl[:, 0] == 2)
        # GET (with and without maintenance) and the PUT plan, standalone
        assert_same(get(js, jnp.asarray(keys), jnp.asarray(valid)),
                    tkv.get(ts, t(keys), t(valid), backend="ref",
                            with_state=True), f"get{it}")
        assert_same(get_plain(js, jnp.asarray(keys)),
                    tkv.get(ts, t(keys), backend="ref"), f"get_nomask{it}")
        jplan = plan(js, jnp.asarray(keys), jnp.asarray(mask))._asdict()
        assert_same({k: jplan[k] for k in tkv.PutPlan._fields},
                    tkv.plan_put(ts, t(keys), t(mask), backend="ref"),
                    f"plan{it}")
        vals = pl[:, 1 + kw: 1 + kw + vw]
        ts_copy = tkv.KVState(*(x.clone() for x in ts))  # put is in place
        assert_same(put(js, jnp.asarray(keys), jnp.asarray(vals),
                        jnp.asarray(mask)),
                    tkv.put(ts_copy, t(keys), t(vals), t(mask)), f"put{it}")
        # the engine hook evolves both states
        js, jresp = step(js, jnp.asarray(pl), jnp.asarray(valid))
        ts, tresp = tkv.app_step(ts, t(pl), t(valid), tcfg,
                                 kernel_backend="auto")
        assert_same((js, jresp), (ts, tresp), f"app_step{it}")
        bad = valid & ~np.isin(pl[:, 0], [0, 1, 2])
        assert (tresp[t(bad), 0] == tst.MALFORMED).all()
    # the traffic reached the cases this test is for
    assert int(ts.alloc) > 0 and int(ts.dropped) > 0
    if tcfg.cache_sets:
        assert int(ts.cache_hits) > 0 and int(ts.cache_evictions) > 0
    # sentinel rows stay zero
    for f in tkv.DURABLE_ROW_ARRAYS:
        assert not getattr(ts, f)[-1].any(), f


def test_put_commits_in_place_and_interop_copies():
    """``put`` writes the store's arrays in place (as the CUDA commit
    does); a state carried across from JAX is a copy, so the JAX state
    that a test compares against is not touched."""
    jcfg, tcfg = _pair("cache")
    js = jkv.make(jcfg)
    ts = interop.kv_state_from_numpy(interop.to_numpy(js), "cpu")
    pool_before = ts.pool
    keys = np.array([[1, 2], [3, 4], [1, 2]], np.int32)
    vals = np.arange(12, dtype=np.int32).reshape(3, 4) + 1
    js2, jok = jax.jit(functools.partial(jkv.put, backend="ref"))(
        js, jnp.asarray(keys), jnp.asarray(vals))
    ts2, tok = tkv.put(ts, t(keys), t(vals), backend="auto")
    assert_same((js2, jok), (ts2, tok))
    assert ts2.pool is pool_before and pool_before.any()  # in place
    assert not np.asarray(js.pool).any()  # JAX state untouched
    back = interop.kv_state_from_numpy(interop.to_numpy(ts2), "cpu")
    assert_same(ts2, back)
    assert back.pool.data_ptr() != ts2.pool.data_ptr()


def test_make_checks_the_cache_budget():
    cfg = tkv.KVConfig(num_buckets=8, ways=2, pool_size=8, cache_sets=2**20)
    with pytest.raises(ValueError, match="L2 budget"):
        tkv.make(cfg, device="cpu")


def test_cuda_backend_on_cpu_state_raises():
    _, tcfg = _pair("nocache")
    ts = tkv.make(tcfg, device="cpu")
    pl = np.zeros((2, tkv.request_words(tcfg)), np.int32)
    pl[:, 0] = 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkv.app_step(ts, t(pl), torch.ones(2, dtype=torch.bool), tcfg,
                     kernel_backend="cuda")
