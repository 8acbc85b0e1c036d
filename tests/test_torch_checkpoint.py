"""The port's checkpointer (``repro_torch/checkpoint/checkpointer.py``)
against the JAX package's: snapshots cross both ways (a TX engine state, a
KVS engine state, and a bf16 paged LM engine state wrapped with its cold
tier as ``{"engine", "cold"}``), the manifests and npz members are equal,
torn ``.tmp`` leftovers are treated alike, and delta records round-trip.

States are filled from a seed with numpy and given to both sides.
"""
from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jckpt
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import engine as jeng
from repro.core import kvstore as jkv
from repro.core import transaction as jtx
from repro.parallel.sharding import local_context as jlocal_context
from repro.serving import kv_cache as jpk
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.configs import get_config, reduced
from repro_torch.core import engine as teng
from repro_torch.core import kvstore as tkv
from repro_torch.core import transaction as ttx
from repro_torch.parallel.sharding import local_context
from repro_torch.serving import kv_cache as tpk
from torch_port_helpers import assert_same

TX = dict(num_keys=16, val_words=2, max_ops=2, chain_len=3, log_capacity=8)
KV = dict(num_buckets=8, ways=2, key_words=2, val_words=4, pool_size=24,
          cache_sets=4, cache_ways=2)
LM_ECFG = dict(num_queues=2, capacity=4, prompt_len=4, gen_len=4, slots=2,
               admit_per_step=1, paged=True, page_size=2, num_pages=6,
               host_pages=6, expected_gen_len=2, kernel_backend="ref")


def _random_leaf(rng):
    def fill(x):
        a = np.asarray(x)
        if a.dtype == bool:
            return rng.random(a.shape) < 0.5
        if a.dtype.name == "bfloat16":
            return np.asarray(jnp.asarray(rng.normal(size=a.shape),
                                          jnp.bfloat16))
        if np.issubdtype(a.dtype, np.floating):
            return rng.normal(size=a.shape).astype(a.dtype)
        return rng.integers(-1000, 1000, a.shape).astype(a.dtype)
    return fill


def _states(app, seed=0):
    """(JAX tree of numpy arrays filled from ``seed``, the port's
    like-tree on the CPU of the same geometry)."""
    rng = np.random.default_rng(seed)
    if app == "tx":
        w = 1 + TX["max_ops"] * (1 + TX["val_words"])
        ecfg = jeng.EngineConfig(num_queues=3, capacity=4, req_words=w,
                                 resp_words=w, budget=4)
        j = jeng.make(ecfg, jtx.make_chain(jtx.TxConfig(**TX)))
        t = teng.make(teng.EngineConfig(**ecfg._asdict()),
                      ttx.make_chain(ttx.TxConfig(**TX), "cpu"))
    elif app == "kvs":
        ecfg = jeng.EngineConfig(num_queues=2, capacity=4, req_words=7,
                                 resp_words=7, budget=4)
        j = jeng.make(ecfg, jkv.make(jkv.KVConfig(**KV)))
        t = teng.make(teng.EngineConfig(**ecfg._asdict()),
                      tkv.make(tkv.KVConfig(**KV), "cpu"))
    else:  # bf16 paged LM engine + its cold tier
        jcfg = jreduced(jget_config("qwen1.5-0.5b"))
        tcfg = reduced(get_config("qwen1.5-0.5b"))
        assert jcfg.dtype == tcfg.dtype == "bfloat16"
        jecfg = jeng.LMEngineConfig(**LM_ECFG)
        tecfg = teng.LMEngineConfig(**LM_ECFG)
        jctx, tctx = jlocal_context(), local_context()
        jpcfg = jeng.lm_paged_kv_config(jecfg, jcfg, jctx)
        tpcfg = teng.lm_paged_kv_config(tecfg, tcfg, tctx)
        jcold = jpk.HostColdTier(jpcfg, 6, dtype=jnp.bfloat16)
        tcold = tpk.HostColdTier(tpcfg, 6, dtype=torch.bfloat16)
        j = {"engine": jeng.lm_make_paged(jecfg, jcfg, jctx),
             "cold": jcold.state_arrays()}
        t = {"engine": teng.lm_make_paged(tecfg, tcfg, tctx, "cpu"),
             "cold": tcold.zero_arrays()}
    j = jax.tree_util.tree_map(_random_leaf(rng),
                               jax.tree_util.tree_map(np.asarray, j))
    return j, t


def _port_tree(jtree, like):
    """The JAX tree carried into the port's structure by flat key."""
    flat = {k: tckpt.from_bits(*tckpt.np_bits(v))
            for k, v in jckpt._flatten(jtree).items()}
    assert list(flat) == list(tckpt._flatten(like)), "flat keys differ"
    return tckpt.rebuild(like, flat)


def _members(path):
    with np.load(os.path.join(path, "host0.npz")) as z:
        return {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                for k in z.files}


APPS = ("tx", "kvs", "lm")


@pytest.mark.parametrize("app", APPS)
def test_jax_snapshot_restores_in_port(tmp_path, app):
    j, like = _states(app, seed=APPS.index(app))
    jckpt.save(str(tmp_path), 3, j)
    got, step = tckpt.restore(str(tmp_path), 3, like)
    assert step == 3
    assert_same(j, got)


@pytest.mark.parametrize("app", APPS)
def test_port_snapshot_restores_in_jax(tmp_path, app):
    j, like = _states(app, seed=10 + APPS.index(app))
    tckpt.save(str(tmp_path), 4, _port_tree(j, like))
    jlike = jax.tree_util.tree_map(jnp.asarray, j)
    got, step = jckpt.restore(str(tmp_path), 4, jlike)
    assert step == 4
    if app == "lm":
        # JAX restores a 64-bit leaf as its 32-bit type (32-bit defaults):
        # the cold tier's bookkeeping comes back int32 there
        assert_same(j["engine"], got["engine"])
        for k, v in j["cold"].items():
            np.testing.assert_array_equal(v, np.asarray(got["cold"][k]))
    else:
        assert_same(j, got)


@pytest.mark.parametrize("app", APPS)
def test_manifests_and_members_equal(tmp_path, app):
    j, like = _states(app, seed=20 + APPS.index(app))
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    pj = jckpt.save(dj, 5, j)
    pt = tckpt.save(dt, 5, _port_tree(j, like))
    with open(os.path.join(pj, "manifest.json")) as f, \
            open(os.path.join(pt, "manifest.json")) as g:
        mj, mt = json.load(f), json.load(g)
    assert mj == mt
    if app == "lm":
        assert mj["dtypes"]["engine/.decode/.k_pages"] == "bfloat16"
        assert mj["dtypes"]["cold/order"] == "int32"  # an int64 leaf
    assert _members(pj) == _members(pt)


def _torn_dir(d):
    tree = {"x": np.arange(3, dtype=np.int32)}
    jckpt.save(d, 2, tree)
    jckpt.save(d, 5, tree)
    os.makedirs(os.path.join(d, "step_7.tmp"))
    with open(os.path.join(d, "step_7.tmp", "host0.npz"), "wb") as f:
        f.write(b"torn")
    os.makedirs(os.path.join(d, "step_9"))  # no manifest: never committed
    with open(os.path.join(d, "wal_8.npz.tmp"), "wb") as f:
        f.write(b"torn delta")


def test_latest_step_and_clean_stale_treat_torn_files_alike(tmp_path):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    _torn_dir(dj)
    shutil.copytree(dj, dt)
    assert jckpt.latest_step(dj) == tckpt.latest_step(dt) == 5
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    assert jckpt.latest_step(dj, clean_stale_files=True) == \
        tckpt.latest_step(dt, clean_stale_files=True) == 5
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    assert "step_7.tmp" not in os.listdir(dt)
    assert jckpt.clean_stale(dj) == tckpt.clean_stale(dt) == []
    assert jckpt.latest_step(str(tmp_path / "none")) is \
        tckpt.latest_step(str(tmp_path / "none")) is None


def test_save_delta_load_delta_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    bf = np.asarray(jnp.asarray(rng.normal(size=(3, 2)), jnp.bfloat16))
    arrays = {
        "i": torch.from_numpy(rng.integers(-9, 9, (4, 3)).astype(np.int32)),
        "l": torch.arange(5, dtype=torch.int64),
        "b": torch.tensor([True, False]),
        "h": torch.from_numpy(bf.view(np.int16).copy()).view(torch.bfloat16),
        "z": torch.zeros((0, 2), dtype=torch.int32),
    }
    meta = {"step": 6, "base_step": 2, "prev_covered": 4, "kind": 0}
    path = tckpt.save_delta(str(tmp_path), 6, arrays, meta)
    assert os.path.basename(path) == "wal_6.npz"
    assert tckpt.list_deltas(str(tmp_path)) == [6]
    got, got_meta = tckpt.load_delta(str(tmp_path), 6)
    assert got_meta == meta
    assert_same(arrays, got)
    # JAX reads the port's record (its bf16 member under the tagged name)
    jarr, jmeta = jckpt.load_delta(str(tmp_path), 6)
    assert jmeta == meta
    assert_same({k: v for k, v in arrays.items() if k != "h"},
                {k: v for k, v in jarr.items() if k != "h::bf16"})
    np.testing.assert_array_equal(jarr["h::bf16"], bf.view(np.uint16))


def test_async_checkpointer_copies_then_writes_in_the_background(tmp_path):
    """``AsyncCheckpointer.save`` copies the tree before it returns (the
    caller may write its tensors in place right after) and commits the
    snapshot on its worker; a worker error surfaces on the next wait."""
    _, like = _states("tx", seed=30)
    tree = _port_tree(_states("tx", seed=31)[0], like)
    want = tckpt.host_copy(tree)
    ac = tckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(6, tree)
    tree.app.store.add_(1)  # in place, as a commit would
    ac.wait()
    got, step = tckpt.restore(str(tmp_path), 6, like)
    assert step == 6 and tckpt.latest_step(str(tmp_path)) == 6
    assert_same(want, got)
    ac.submit(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        ac.wait()
    assert not ac.busy()
