"""The port's durability tier (``repro_torch/fault/recovery.py``) against the
JAX package's: the same TX and KVS engine timelines, flushed by both
packages' ``DurabilityManager``, give the same flush kinds and bytes, the
same segment files byte for byte and the same snapshots; each package's
``recover`` of the JAX-written directory gives the same state; the
``MemoryBudget`` ledger behaves alike; and the port's crash soaks equal
their never-crashed twins bit for bit.

Engine inputs are made from a seed with numpy and given to both sides;
the engines start equal (carried across with ``interop``).
"""
from __future__ import annotations

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import kvstore as jkv
from repro.core import placement as jplace
from repro.core import transaction as jtx
from repro.core import tx_app as japp
from repro.fault import recovery as jfrec
from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.core import kvstore as tkv
from repro_torch.core import placement as tplace
from repro_torch.core import transaction as ttx
from repro_torch.core import tx_app as tapp
from repro_torch.fault import recovery as tfrec
from repro_torch.fault import soak as tsoak
from torch_port_helpers import assert_same


def _engines(app, log_capacity=64):
    """(JAX state, step, drain), (port state, step, drain), payload maker."""
    if app == "tx":
        kw = dict(num_keys=16, val_words=2, max_ops=2, chain_len=3,
                  log_capacity=log_capacity)
        jcfg, tcfg = jtx.TxConfig(**kw), ttx.TxConfig(**kw)
        w = japp.request_words(jcfg)
        jmod, tmod, japp_state = japp, tapp, jtx.make_chain(jcfg)
        from_np = interop.replica_state_from_numpy

        def payload(rng, q):
            n = int(rng.integers(1, 3))
            words = [n]
            for j in range(2):
                words += ([q * 8 + int(rng.integers(0, 8)),
                           *rng.integers(1, 1 << 15, 2)] if j < n
                          else [0, 0, 0])
            return words
    else:
        kw = dict(num_buckets=64, ways=4, key_words=2, val_words=4,
                  pool_size=256)
        jcfg, tcfg = jkv.KVConfig(**kw), tkv.KVConfig(**kw)
        w = jkv.request_words(jcfg)
        jmod, tmod, japp_state = jkv, tkv, jkv.make(jcfg)
        from_np = interop.kv_state_from_numpy

        def payload(rng, q):
            op = jkv.OP_PUT if rng.random() < 0.8 else jkv.OP_GET
            return [op, q * 16 + int(rng.integers(0, 16)), 5,
                    *rng.integers(1, 1 << 15, 4)]
    ekw = dict(num_queues=2, capacity=8, req_words=w, resp_words=w, budget=4,
               kernel_backend="ref")
    jecfg, tecfg = jeng.EngineConfig(**ekw), teng.EngineConfig(**ekw)
    js = jeng.make(jecfg, japp_state)
    ts = interop.engine_state_from_numpy(interop.to_numpy(js), "cpu",
                                         app_from_numpy=from_np)
    jfn = jeng.bind_app(jmod.app_step, jcfg, jecfg)
    tfn = teng.bind_app(tmod.app_step, tcfg, tecfg)
    jstep = jax.jit(lambda s: jeng.engine_step(s, jfn, jecfg)[0])
    jdrain = jax.jit(lambda s: jeng.drain_responses(s, jecfg.capacity)[2])

    def tlike():
        return interop.engine_state_from_numpy(
            interop.to_numpy(jeng.make(jecfg, japp_state)), "cpu",
            app_from_numpy=from_np)

    return ((js, jstep, jdrain),
            (ts, lambda s: teng.engine_step(s, tfn, tecfg)[0],
             lambda s: teng.drain_responses(s, tecfg.capacity)[2]),
            payload, jeng.make(jecfg, japp_state), tlike)


TIMELINES = {
    # name: app, steps, flush steps, DurabilityConfig kwargs, extras
    "tx_adaptive_full_then_delta": ("tx", 6, range(6), dict(
        mode="adaptive", snapshot_every=1000, group_records=2), {}),
    "tx_dirty_threshold_escape": ("tx", 4, range(4), dict(
        mode="adaptive", snapshot_every=1000, dirty_threshold=0.0), {}),
    "tx_snapshot_every": ("tx", 6, range(6), dict(
        mode="delta", snapshot_every=2), {}),
    "tx_log_lap": ("tx", 6, (0, 5), dict(
        mode="delta", snapshot_every=1000), {"log_capacity": 4}),
    "tx_dead_replica": ("tx", 5, (1, 4), dict(
        mode="delta", snapshot_every=1000), {"kill_at": 2}),
    "tx_budget_pressure": ("tx", 4, range(4), dict(
        mode="adaptive", snapshot_every=1000, dirty_threshold=0.0),
        {"budget": True}),
    "kvs_delta": ("kvs", 6, (1, 3, 5), dict(
        mode="delta", snapshot_every=1000), {}),
    "kvs_adaptive": ("kvs", 8, range(8), dict(
        mode="adaptive", snapshot_every=4, group_records=3), {}),
    "kvs_npz": ("kvs", 4, range(4), dict(
        mode="delta", snapshot_every=1000, wal="npz"), {}),
}


def _budget(mod):
    b = mod.MemoryBudget(dram_bytes=10, nvm_bytes=1 << 20)
    b.reserve("pinned", 10)
    return b


def _run(name, dj, dt):
    app, steps, flush_at, dkw, extra = TIMELINES[name]
    (js, jstep, jdrain), (ts, tstep, tdrain), payload, jlike, tlike = \
        _engines(app, extra.get("log_capacity", 64))
    jb = _budget(jplace) if extra.get("budget") else None
    tb = _budget(tplace) if extra.get("budget") else None
    jm = jfrec.DurabilityManager(jfrec.DurabilityConfig(dj, **dkw), budget=jb)
    tm = tfrec.DurabilityManager(tfrec.DurabilityConfig(dt, **dkw), budget=tb)
    rng = np.random.default_rng(len(name))
    qids = np.arange(2, dtype=np.int32)
    for t in range(steps):
        pays = np.asarray([payload(rng, q) for q in range(2)], np.int32)
        js = jeng.inject(js, jnp.asarray(qids), jnp.asarray(pays))
        ts = teng.inject(ts, qids, pays)
        js, ts = jstep(js), tstep(ts)
        if t == extra.get("kill_at"):
            js = js._replace(app=js.app._replace(
                live=js.app.live.at[1].set(False)))
            live = ts.app.live.clone()
            live[1] = False
            ts = ts._replace(app=ts.app._replace(live=live))
        if t in flush_at:
            jm.flush(js)
            tm.flush(ts)
        js, ts = jdrain(js), tdrain(ts)
    jm.wait()
    tm.wait()
    return js, ts, jm, tm, jlike, tlike


def _files(d):
    out = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            path = os.path.join(root, f)
            rel = os.path.relpath(path, d)
            if f.endswith(".npz"):
                with np.load(path) as z:
                    out[rel] = {k: (z[k].dtype.str, z[k].tobytes())
                                for k in z.files}
            else:
                with open(path, "rb") as fh:
                    out[rel] = fh.read()
    return out


@pytest.mark.parametrize("name", sorted(TIMELINES))
def test_flush_sequence_and_files_match_jax(tmp_path, name):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    js, ts, jm, tm, _, _ = _run(name, dj, dt)
    assert_same(js, ts)
    jrec = [(r.step, r.kind, r.bytes, r.committed) for r in jm.records]
    trec = [(r.step, r.kind, r.bytes, r.committed) for r in tm.records]
    assert jrec == trec
    for k in ("fsyncs", "wal_records", "disk_bytes", "gc_removed"):
        assert jm.stats()[k] == tm.stats()[k], k
    assert _files(dj) == _files(dt)
    kinds = [r[1] for r in trec]
    want = {
        "tx_adaptive_full_then_delta": ["full"] + ["delta"] * 5,
        "tx_dirty_threshold_escape": ["full"] * 4,
        "tx_snapshot_every": ["full", "delta"] * 3,
        "tx_log_lap": ["full", "full"],
        "tx_budget_pressure": ["full"] + ["delta"] * 3,
    }.get(name)
    if want is not None:
        assert kinds == want


@pytest.mark.parametrize("name", sorted(TIMELINES))
def test_port_recovers_jax_directory(tmp_path, name):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "torch")
    js, ts, _, _, jlike, tlike = _run(name, dj, dt)
    shutil.copytree(dj, str(tmp_path / "jax2"))
    jout, jcov = jfrec.recover(dj, jlike)
    stats = {}
    tout, tcov = tfrec.recover(str(tmp_path / "jax2"), tlike(), stats=stats)
    assert jcov == tcov
    assert tcov == stats["snapshot_step"] or stats["wal_records"] > 0
    assert_same(jout, tout)
    own, own_cov = tfrec.recover(dt, tlike())
    assert own_cov == tcov
    assert_same(jout, own)


def test_settled_depends_on_the_flush_sequence_only(tmp_path):
    (_, _, _), (ts, tstep, tdrain), payload, _, _ = _engines("tx")
    mgr = tfrec.DurabilityManager(tfrec.DurabilityConfig(
        str(tmp_path), mode="delta", snapshot_every=1000, group_records=2))
    rng = np.random.default_rng(0)
    recs, settled = [], []
    for _ in range(5):
        pays = np.asarray([payload(rng, q) for q in range(2)], np.int32)
        ts = tstep(teng.inject(ts, np.arange(2, dtype=np.int32), pays))
        recs.append(mgr.flush(ts))
        settled.append(mgr.settled())
        ts = tdrain(ts)
    # full at 0; deltas commit in groups of 2 (fsync on the 2nd)
    assert settled == [None, recs[0], recs[0], recs[2], recs[2]]
    mgr.wait()
    assert mgr.settled() is recs[4] and all(r.committed for r in recs)
    assert mgr.stats()["host_copy_bytes"] == sum(r.copy_bytes for r in recs)


def test_memory_budget_matches_jax():
    jb = jplace.MemoryBudget(dram_bytes=100, nvm_bytes=50)
    tb = tplace.MemoryBudget(dram_bytes=100, nvm_bytes=50)
    ops = [("reserve", "a", 60), ("reserve", "a", 10), ("reserve", "b", 50),
           ("reserve", "b", 40), ("threshold", 0.4), ("release", "a"),
           ("reserve", "c1", 10), ("reserve", "c2", 10), ("threshold", 0.2),
           ("release_prefix", "c"), ("note_write", 33), ("reserve", "n", 60,
                                                          "nvm"),
           ("reserve", "n", 40, "nvm"), ("release", "zz"), ("threshold", 0.9)]
    for op, *args in ops:
        if op == "threshold":
            assert jb.durability_threshold(*args) == \
                tb.durability_threshold(*args)
        else:
            assert getattr(jb, op)(*args) == getattr(tb, op)(*args), op
        for side in ("dram", "nvm"):
            assert (jb.used(side), jb.free(side), jb.free_frac(side)) == \
                (tb.used(side), tb.free(side), tb.free_frac(side))
    assert jb.bytes_written == tb.bytes_written
    assert jb.capacity == tb.capacity


@pytest.mark.parametrize("crash_at", [None, 21])
def test_port_crash_soak_equals_its_twin(crash_at):
    """Recovered state == the never-crashed twin's at the covered step, bit
    for bit (checked inside ``run_crash_soak``), with the release gated on
    settled coverage, so the outcome does not depend on the worker."""
    r = tsoak.run_crash_soak(seed=11, steps=40, crash_at=crash_at,
                             device="cpu")
    c = r["crash"]
    assert c["torn_cleaned"] and c["torn_segment_truncated"]
    assert r["covered"] == c["covered"] and c["covered"] <= c["wall_step"]
    assert r["responses"] == r["counters"]["landed"]
    assert c["recovered_state"].steps.dtype == torch.int32


def test_flush_host_copies_are_freed_without_the_cycle_collector():
    """Each flush's host copy is freed by reference counting once the
    worker is done with it: with the cyclic collector off, a crash soak
    never holds more than the three copies the one-outstanding design
    needs (the new flush, the worker's, the one being dropped). A
    reference cycle here keeps multi-GB copies alive on the card's host."""
    import gc
    import weakref

    from repro_torch.checkpoint import checkpointer as tckpt

    alive, peak = set(), [0]
    copy_leaf = tckpt._host_leaf

    def tracked(x):
        y = copy_leaf(x)
        if isinstance(y, torch.Tensor) and y.numel() > 1000:
            alive.add(id(y))
            weakref.finalize(y, alive.discard, id(y))
            peak[0] = max(peak[0], len(alive))
        return y

    enabled = gc.isenabled()
    gc.disable()
    tckpt._host_leaf = tracked
    try:
        r = tsoak.run_crash_soak(seed=11, steps=40, snapshot_every=32,
                                 device="cpu")
    finally:
        tckpt._host_leaf = copy_leaf
        if enabled:
            gc.enable()
    # the crash soak also keeps two copies on purpose: the recovered
    # state and the twin's capture
    assert peak[0] <= 5, peak[0]
    assert len(r["flush_records"]) > 20
