"""The port's chain failover (``repro_torch/fault/chain.py``) against the
JAX package's, bit for bit: ``resync_replica`` inside the log ring and by
full copy when the ring lapped, its two refusals, and ``ChainMonitor`` in
schedule mode and in a heartbeat sweep with an explicit ``now``.

Chains are built on the JAX side from seeded numpy batches and carried
across with ``interop``; every resync runs on both sides.
"""
from __future__ import annotations

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import transaction as jtx
from repro.fault import chain as jchain
from repro_torch import interop
from repro_torch.core import transaction as ttx
from repro_torch.fault import chain as tchain
from torch_port_helpers import assert_same


def _cfgs(**kw):
    return jtx.TxConfig(**kw), ttx.TxConfig(**kw)


def _batches(cfg, n, b, rng, offsets):
    """n (B, TW) batches of 1..M write ops over ``offsets`` keys."""
    out = []
    for _ in range(n):
        batch = np.zeros((b, jtx.tx_words(cfg)), np.int32)
        for i in range(b):
            k = int(rng.integers(1, cfg.max_ops + 1))
            batch[i, 0] = k
            for j in range(k):
                base = 1 + j * (1 + cfg.val_words)
                batch[i, base] = rng.integers(0, offsets)
                batch[i, base + 1: base + 1 + cfg.val_words] = \
                    rng.integers(-99, 99, cfg.val_words)
        out.append(jnp.asarray(batch))
    return out


_jcommit = jax.jit(jtx.chain_commit_local, static_argnums=2,
                   static_argnames="kernel_backend")


def _commit(chain, cfg, batches):
    for b in batches:
        chain, _, _ = _jcommit(chain, b, cfg, jnp.ones((b.shape[0],), bool),
                               kernel_backend="ref")
    return chain


def _to_port(chain):
    return interop.replica_state_from_numpy(interop.to_numpy(chain), "cpu")


def _kill(chain, r):
    return chain._replace(live=chain.live.at[r].set(False))


@pytest.mark.parametrize("seed,dead,chain_len", [(0, 1, 3), (1, 0, 3),
                                                  (2, 2, 3), (3, 1, 2)])
def test_resync_inside_the_ring_matches_jax(seed, dead, chain_len):
    jcfg, tcfg = _cfgs(num_keys=32, val_words=3, max_ops=3,
                       chain_len=chain_len, log_capacity=64)
    rng = np.random.default_rng(seed)
    c = _commit(jtx.make_chain(jcfg), jcfg, _batches(jcfg, 2, 4, rng, 32))
    c = _commit(_kill(c, dead), jcfg, _batches(jcfg, 5, 6, rng, 12))
    gap = int(c.log_tail.max()) - int(c.log_tail[dead])
    assert 0 < gap <= jcfg.log_capacity
    tc = _to_port(c)
    want = jchain.resync_replica(c, jcfg, dead)
    got = tchain.resync_replica(tc, tcfg, dead, kernel_backend="ref")
    assert_same(want, got)
    assert bool(got.live.all())


def test_resync_full_copy_when_ring_lapped_matches_jax():
    jcfg, tcfg = _cfgs(num_keys=16, val_words=1, max_ops=1, chain_len=3,
                       log_capacity=4)
    rng = np.random.default_rng(7)
    c = _commit(_kill(jtx.make_chain(jcfg), 1), jcfg,
                _batches(jcfg, 6, 1, rng, 16))
    assert int(c.log_tail[0]) - int(c.log_tail[1]) > jcfg.log_capacity
    got = tchain.resync_replica(_to_port(c), tcfg, 1)
    assert_same(jchain.resync_replica(c, jcfg, 1), got)


def test_resync_refusals_match_jax():
    jcfg, tcfg = _cfgs(num_keys=16, val_words=2, max_ops=2, chain_len=3,
                       log_capacity=8)
    ahead = jtx.make_chain(jcfg)
    ahead = ahead._replace(log_tail=ahead.log_tail.at[1].set(3))
    for fn, c, cfg in ((jchain.resync_replica, ahead, jcfg),
                       (tchain.resync_replica, _to_port(ahead), tcfg)):
        with pytest.raises(ValueError, match="ahead of source"):
            fn(c, cfg, 1, source=0)
    jone, tone = _cfgs(num_keys=8, val_words=1, max_ops=1, chain_len=1,
                       log_capacity=4)
    dead = _kill(jtx.make_chain(jone), 0)
    for fn, c, cfg in ((jchain.resync_replica, dead, jone),
                       (tchain.resync_replica, _to_port(dead), tone)):
        with pytest.raises(ValueError, match="no live source"):
            fn(c, cfg, 0)


def test_monitor_schedule_mode_matches_jax():
    jcfg, tcfg = _cfgs(num_keys=16, val_words=2, max_ops=2, chain_len=3,
                       log_capacity=8)
    rng = np.random.default_rng(3)
    jm, tm = jchain.ChainMonitor(jcfg), tchain.ChainMonitor(tcfg)
    jc = jtx.make_chain(jcfg)
    tc = _to_port(jc)
    for events in ([("kill", 1)], [("kill", 0)], [("revive", 1)],
                   [("revive", 0), ("kill", 2)], [("revive", 2)]):
        jc = jm.apply_events(jc, events)
        tc = tm.apply_events(tc, events)
        assert_same(jc, tc)
        # the survivors commit while a replica is out (carried across)
        jc = _commit(jc, jcfg, _batches(jcfg, 2, 3, rng, 16))
        tc = _to_port(jc)
    assert jm.events == tm.events
    for mon, c in ((jm, jc), (tm, tc)):
        c = mon.kill(mon.kill(c, 0), 1)
        with pytest.raises(ValueError, match="last live replica"):
            mon.kill(c, 2)


def test_monitor_heartbeat_sweep_matches_jax(tmp_path):
    jcfg, tcfg = _cfgs(num_keys=16, val_words=2, max_ops=2, chain_len=3,
                       log_capacity=8)
    rng = np.random.default_rng(4)
    now = time.time()
    mons = {}
    for name, mod, cfg in (("jax", jchain, jcfg), ("torch", tchain, tcfg)):
        m = mod.ChainMonitor(cfg, directory=str(tmp_path / name),
                             timeout=5.0)
        for r in (0, 1):  # replica 2 never beats: never admitted
            m.beat(r)
        os.utime(m.hbs[1].path, (now - 60, now - 60))  # 1 goes stale
        mons[name] = m
    jc = jtx.make_chain(jcfg)
    tc = _to_port(jc)
    jc = mons["jax"].sweep(jc, now=now)
    tc = mons["torch"].sweep(tc, now=now)
    assert_same(jc, tc)
    assert [bool(x) for x in tc.live] == [True, False, True]
    jc = _commit(jc, jcfg, _batches(jcfg, 3, 2, rng, 16))
    tc = _to_port(jc)
    for m in mons.values():
        m.beat(1)  # the heartbeat comes back: revive and resync
    jc = mons["jax"].sweep(jc, now=now)
    tc = mons["torch"].sweep(tc, now=now)
    assert_same(jc, tc)
    assert bool(tc.live.all())
    assert mons["jax"].events == mons["torch"].events == [
        ("kill", 1), ("revive", 1)]
    with pytest.raises(ValueError, match="heartbeat directory"):
        tchain.ChainMonitor(tcfg).sweep(tc)
