"""The TX slice of the PyTorch port against the JAX package, bit for bit
(int32 state): the commit kernels' plain versions against the Pallas
kernels in interpret mode, the modules of ``core/transaction.py`` and
``core/tx_app.py`` field by field, and the engine serving TX.

Inputs are made from a seed with numpy and given to both sides; states
start equal (carried across with ``interop``) and are compared whole.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import transaction as jtx
from repro.core import tx_app as japp
from repro.kernels import tx_commit as jtc
from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.core import ringbuf as trb
from repro_torch.core import status as tst
from repro_torch.core import transaction as ttx
from repro_torch.core import tx_app as tapp
from repro_torch.kernels import ops as tops
from torch_port_helpers import assert_same, t
from tx_commit_cases import IN_RANGE, edge_case, replica

I32 = jnp.int32
# the JAX side runs jitted where it loops (eager JAX dispatch dominates)
_jchain_local = jax.jit(jtx.chain_commit_local, static_argnums=2,
                        static_argnames="kernel_backend")
_japp_step = jax.jit(japp.app_step, static_argnums=3,
                     static_argnames="kernel_backend")


def _cfgs(**kw):
    return jtx.TxConfig(**kw), ttx.TxConfig(**kw)


def _tx_batch(cfg, b, rng, offset_space=None, dup=0.0):
    """(B, TW) records of 1..M write ops over ``offset_space`` offsets
    (small: in-batch conflicts); ``dup`` is the chance that an op repeats
    an earlier offset of its own transaction (intra-tx duplicates)."""
    w = jtx.tx_words(cfg)
    out = np.zeros((b, w), np.int32)
    hi = offset_space or cfg.num_keys
    for i in range(b):
        n = int(rng.integers(1, cfg.max_ops + 1))
        out[i, 0] = n
        offs = []
        for j in range(n):
            base = 1 + j * (1 + cfg.val_words)
            off = (offs[int(rng.integers(len(offs)))]
                   if offs and rng.random() < dup else int(rng.integers(0, hi)))
            offs.append(off)
            out[i, base] = off
            out[i, base + 1: base + 1 + cfg.val_words] = \
                rng.integers(-99, 99, cfg.val_words)
    return out


def _chain_state(cfg, rng, skew=False, dead=None):
    """A JAX chain with random store and log contents (sentinel rows
    zero), optionally skewed per-replica log tails and a dead replica."""
    r, nk, lc = cfg.chain_len, cfg.num_keys, cfg.log_capacity
    store = rng.integers(-50, 50, (r, nk + 1, cfg.val_words)).astype(np.int32)
    log = rng.integers(-50, 50, (r, lc + 1, jtx.tx_words(cfg))).astype(np.int32)
    store[:, nk], log[:, lc] = 0, 0
    tail = (rng.integers(0, 3 * lc, r) if skew
            else np.full(r, int(rng.integers(0, 3 * lc)))).astype(np.int32)
    live = np.ones(r, bool)
    if dead is not None:
        live[dead] = False
    return jtx.ReplicaState(jnp.asarray(store), jnp.asarray(log),
                            jnp.asarray(tail), jnp.asarray(tail + 5),
                            jnp.asarray(live))


def _to_torch(jstate):
    return interop.replica_state_from_numpy(interop.to_numpy(jstate), "cpu")


# --------------------------- commit kernels ---------------------------------

@pytest.mark.parametrize("b", [1, 5, 8])
def test_tx_commit_plain_matches_pallas(b):
    """ops.tx_commit (plain version, in place) vs the Pallas ``commit`` in
    interpret mode on a planned batch: sentinel slots and rows carry
    non-zero payloads that must land as zeros."""
    jcfg, tcfg = _cfgs(num_keys=32, val_words=4, max_ops=4, chain_len=1,
                       log_capacity=8)
    rng = np.random.default_rng(b)
    rep = jax.tree_util.tree_map(lambda x: x[0], _chain_state(jcfg, rng))
    batch = _tx_batch(jcfg, b, rng, offset_space=12, dup=0.3)
    mask = rng.random(b) < 0.8
    plan = jtx.plan_commit(jnp.asarray(batch), jcfg, jnp.asarray(mask))
    lc = jcfg.log_capacity
    slot = jnp.where(plan.proceed, (rep.log_tail + plan.log_rank) % lc, lc)
    want = jtc.commit(rep.log, rep.store, plan.batch, plan.values, slot,
                      plan.store_rows, interpret=True)
    log, store = t(rep.log), t(rep.store)
    got = tops.tx_commit(log, store, t(plan.batch), t(plan.values), t(slot),
                         t(plan.store_rows))
    assert got[0] is log and got[1] is store  # in place
    assert_same(want, got, "tx_commit")
    assert not log[lc].any() and not store[jcfg.num_keys].any()


@pytest.mark.parametrize("rows_kind", ["shared", "per_replica"])
@pytest.mark.parametrize("dead", [None, 1])
def test_tx_commit_chain_plain_matches_pallas(rows_kind, dead):
    """ops.tx_commit_chain vs the Pallas ``commit_chain``: per-replica
    slots from skewed tails, shared (B*M,) or per-replica (R, B*M) rows,
    and a dead replica whose targets are all sentinels."""
    jcfg, tcfg = _cfgs(num_keys=24, val_words=2, max_ops=3, chain_len=3,
                       log_capacity=6)
    rng = np.random.default_rng(11 if dead is None else 12)
    chain = _chain_state(jcfg, rng, skew=True, dead=dead)
    batch = _tx_batch(jcfg, 7, rng, offset_space=10, dup=0.3)
    plan = jtx.plan_commit(jnp.asarray(batch), jcfg)
    lc, nk = jcfg.log_capacity, jcfg.num_keys
    slot = jnp.where(plan.proceed[None, :] & chain.live[:, None],
                     (chain.log_tail[:, None] + plan.log_rank[None, :]) % lc,
                     lc)
    rows = plan.store_rows
    if rows_kind == "per_replica":
        rows = jnp.where(chain.live[:, None], rows[None, :], nk)
    want = jtc.commit_chain(chain.log, chain.store, plan.batch, plan.values,
                            slot, rows, interpret=True)
    log, store = t(chain.log), t(chain.store)
    got = tops.tx_commit_chain(log, store, t(plan.batch), t(plan.values),
                               t(slot), t(rows))
    assert got[0] is log and got[1] is store  # in place
    assert_same(want, got, "tx_commit_chain")
    if dead is not None and rows_kind == "per_replica":
        assert_same(chain.store[dead], store[dead], "dead replica store")
        assert_same(chain.log[dead], log[dead], "dead replica log")


@pytest.mark.parametrize("case", IN_RANGE)
@pytest.mark.parametrize("kernel", ["commit", "commit_chain_shared",
                                    "commit_chain_per_replica"])
def test_tx_commit_sentinel_rows_match_pallas(case, kernel):
    """The plain versions against the Pallas kernels in interpret mode on
    sentinel rows that are NOT zero on entry: a sentinel row that some
    target aims at ends all-zero, one that no target aims at keeps its
    contents, and an all-deferred batch (every target a sentinel) writes
    nothing else. These pin what the CUDA kernel keeps."""
    chain = kernel != "commit"
    lc, nk = 8, 24
    c = edge_case(case, seed=len(case) + len(kernel), r=3 if chain else 1,
                  b=6, m=3, vw=4, lc=lc, nk=nk,
                  shared_rows=kernel.endswith("shared"))
    if chain:
        args = [c[k] for k in ("log", "store", "batch", "values", "slot",
                               "rows")]
        want = jtc.commit_chain(*map(jnp.asarray, args), interpret=True)
        got = tops.tx_commit_chain(*map(t, args))
    else:
        c = replica(c)
        args = [c[k] for k in ("log", "store", "batch", "values", "slot",
                               "rows")]
        want = jtc.commit(*map(jnp.asarray, args), interpret=True)
        got = tops.tx_commit(*map(t, args))
    assert_same(want, got, f"{kernel} {case}")
    log, store = (x.numpy().reshape((-1,) + x.shape[-2:]) for x in got)
    slot = c["slot"].reshape(log.shape[0], -1)
    rows = np.broadcast_to(c["rows"], (log.shape[0], c["rows"].shape[-1]))
    entry_log = c["log"].reshape(log.shape)
    entry_store = c["store"].reshape(store.shape)
    for k in range(log.shape[0]):
        for now, entry, tgt, lim in ((log, entry_log, slot, lc),
                                     (store, entry_store, rows, nk)):
            if (tgt[k] == lim).any():
                assert not now[k, lim].any()
            else:
                assert entry[k, lim].all()
                np.testing.assert_array_equal(now[k, lim], entry[k, lim])
    if case == "all_deferred":
        np.testing.assert_array_equal(log[:, :lc], entry_log[:, :lc])
        np.testing.assert_array_equal(store[:, :nk], entry_store[:, :nk])


# ------------------------------ modules -------------------------------------

CASES = {
    # name: (config kwargs, batch, offset_space, dup, mask?)
    "conflicts": (dict(num_keys=32, val_words=2, max_ops=3, chain_len=2,
                       log_capacity=16), 9, 8, 0.0, True),
    "intra_tx_dups": (dict(num_keys=32, val_words=3, max_ops=4, chain_len=3,
                           log_capacity=16), 6, 20, 0.5, False),
    "lapping": (dict(num_keys=64, val_words=2, max_ops=2, chain_len=2,
                     log_capacity=4), 10, 64, 0.2, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_parse_concurrency_and_plan_match_jax(name):
    kw, b, space, dup, masked = CASES[name]
    jcfg, tcfg = _cfgs(**kw)
    rng = np.random.default_rng(len(name))
    batch = _tx_batch(jcfg, b, rng, offset_space=space, dup=dup)
    batch[0, 0] = jcfg.max_ops + 3  # clamped op count
    batch[-1, 1] = jcfg.num_keys + 5  # clamped offset
    mask = rng.random(b) < 0.8 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else t(mask)
    jp = jtx.parse_tx(jnp.asarray(batch), jcfg)
    tp = ttx.parse_tx(t(batch), tcfg)
    assert_same(jp, tp, "parse_tx")
    assert_same(jtx.concurrency_control(jp[0], jp[1], jcfg, jm),
                ttx.concurrency_control(tp[0], tp[1], tcfg, tm),
                "concurrency_control")
    jplan = jtx.plan_commit(jnp.asarray(batch), jcfg, jm)
    tplan = ttx.plan_commit(t(batch), tcfg, tm)
    assert_same(jplan, tplan, "plan")
    forced = np.ones(b, bool)
    assert_same(jtx.plan_commit(jnp.asarray(batch), jcfg,
                                proceed=jnp.asarray(forced)),
                ttx.plan_commit(t(batch), tcfg, proceed=t(forced)),
                "plan(proceed)")


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("live", [True, False])
def test_replica_commit_matches_jax(name, live):
    kw, b, space, dup, masked = CASES[name]
    jcfg, tcfg = _cfgs(**kw)
    rng = np.random.default_rng(100 + len(name))
    rep = jax.tree_util.tree_map(lambda x: x[0], _chain_state(jcfg, rng))
    rep = rep._replace(live=jnp.asarray(live))
    batch = _tx_batch(jcfg, b, rng, offset_space=space, dup=dup)
    jplan = jtx.plan_commit(jnp.asarray(batch), jcfg)
    trep = _to_torch(rep)
    want = jtx.replica_commit(rep, jplan)
    got = ttx.replica_commit(trep, ttx.plan_commit(t(batch), tcfg))
    assert_same(want, got, "replica_commit")
    assert got.store is trep.store  # committed in place


def test_replay_records_matches_jax():
    """Replaying a source replica's records past a clone's tail rebuilds
    its store, log and counters, on both sides alike."""
    jcfg, tcfg = _cfgs(num_keys=32, val_words=2, max_ops=3, chain_len=1,
                       log_capacity=8)
    rng = np.random.default_rng(5)
    src = jtx.make_replica(jcfg)
    records = []
    for _ in range(3):
        batch = _tx_batch(jcfg, 4, rng, offset_space=12, dup=0.3)
        plan = jtx.plan_commit(jnp.asarray(batch), jcfg)
        src = jtx.replica_commit(src, plan)
        records += [r for r, p in zip(batch, np.asarray(plan.proceed)) if p]
    want = jtx.replay_records(jtx.make_replica(jcfg), records, jcfg)
    got = ttx.replay_records(ttx.make_replica(tcfg, device="cpu"), records,
                             tcfg)
    assert_same(want, got, "replay_records")
    assert_same(src, got, "replay == source")


@pytest.mark.parametrize("skew,dead", [(False, None), (True, None),
                                       (True, 1), (False, 0)])
def test_chain_commit_local_matches_jax_across_rounds(skew, dead):
    """chain_commit_local over several conflicted, masked rounds that wrap
    the log ring, with skewed tails and a dead replica: every field and
    the committed/deferred masks equal JAX's; chain_commit_apply with
    JAX's plan too."""
    jcfg, tcfg = _cfgs(num_keys=48, val_words=2, max_ops=3, chain_len=3,
                       log_capacity=8)
    rng = np.random.default_rng(3 + (dead or 0) + 10 * skew)
    jc = _chain_state(jcfg, rng, skew=skew, dead=dead)
    tc = _to_torch(jc)
    for step in range(5):
        batch = _tx_batch(jcfg, 6, rng, offset_space=16, dup=0.2)
        mask = rng.random(6) < 0.8
        jc, jp, jd = _jchain_local(jc, jnp.asarray(batch), jcfg,
                                   jnp.asarray(mask), kernel_backend="ref")
        tc, tp, td = ttx.chain_commit_local(tc, t(batch), tcfg, t(mask))
        assert_same((jc, jp, jd), (tc, tp, td), f"round {step}")
    jplan = jtx.plan_commit(jnp.asarray(batch), jcfg)
    assert_same(jtx.chain_commit_apply(jc, jplan),
                ttx.chain_commit_apply(tc, ttx.plan_commit(t(batch), tcfg)),
                "chain_commit_apply")
    assert int(tc.log_tail.max()) > tcfg.log_capacity  # the ring wrapped


def test_make_chain_replicas_own_their_memory():
    """make_chain must not hand out stride-0 views: a dead replica 1 keeps
    its store while replica 0's changes."""
    jcfg, tcfg = _cfgs(num_keys=16, val_words=2, max_ops=2, chain_len=3,
                       log_capacity=8)
    jchain, chain = jtx.make_chain(jcfg), ttx.make_chain(tcfg, device="cpu")
    assert_same(jchain, chain, "make_chain")
    assert_same(jtx.make_replica(jcfg), ttx.make_replica(tcfg, device="cpu"))
    chain = chain._replace(live=torch.tensor([True, False, True]))
    batch = np.zeros((1, ttx.tx_words(tcfg)), np.int32)
    batch[0, :4] = [1, 5, 7, 8]
    chain, ok, _ = ttx.chain_commit_local(chain, t(batch), tcfg)
    assert bool(ok[0])
    assert chain.store[0, 5].tolist() == [7, 8]
    assert chain.store[2, 5].tolist() == [7, 8]
    assert not chain.store[1].any() and not chain.log[1].any()
    assert chain.log_tail.tolist() == [1, 0, 1]


def test_batch_larger_than_log_capacity_laps_like_jax():
    """One batch committing more transactions than log_capacity keeps only
    the last LC records (sequential append order), as JAX does."""
    jcfg, tcfg = _cfgs(num_keys=64, val_words=2, max_ops=1, chain_len=2,
                       log_capacity=4)
    b = 8
    batch = np.zeros((b, jtx.tx_words(jcfg)), np.int32)
    batch[:, 0] = 1
    batch[:, 1] = np.arange(b)
    batch[:, 2:4] = np.arange(b)[:, None] + 100
    want = _jchain_local(jtx.make_chain(jcfg), jnp.asarray(batch), jcfg,
                         kernel_backend="ref")
    got = ttx.chain_commit_local(ttx.make_chain(tcfg, device="cpu"), t(batch),
                                 tcfg)
    assert_same(want, got, "lapping batch")
    assert got[0].live_log[0].tolist() == batch[4:8].tolist()


def test_chain_hops_matches_jax():
    jcfg, tcfg = _cfgs(chain_len=4)
    for n_ops in (1, 3):
        for per_op in (False, True):
            assert (ttx.chain_hops(tcfg, n_ops, per_op)
                    == jtx.chain_hops(jcfg, n_ops, per_op))


# ------------------------------ tx_app --------------------------------------

def test_tx_app_step_matches_jax_with_malformed():
    """app_step over rounds with MALFORMED op counts (negative, too many)
    and live offsets out of range, invalid rows, zero-count no-ops, and
    a trailing deadline word past the log-entry layout."""
    jcfg, tcfg = _cfgs(num_keys=32, val_words=2, max_ops=3, chain_len=2,
                       log_capacity=8)
    rng = np.random.default_rng(9)
    jc, tc = jtx.make_chain(jcfg), ttx.make_chain(tcfg, device="cpu")
    w = japp.request_words(jcfg) + 1
    assert tapp.request_words(tcfg) == japp.request_words(jcfg)
    for step in range(4):
        pls = np.zeros((8, w), np.int32)
        pls[:, :-1] = _tx_batch(jcfg, 8, rng, offset_space=10)
        pls[:, -1] = rng.integers(0, 50, 8)
        pls[0, 0] = -1  # negative count
        pls[1, 0] = jcfg.max_ops + 1  # overflow
        pls[2, 0], pls[2, 1] = 1, jcfg.num_keys  # live offset out of range
        pls[3, 0], pls[3, 4] = 1, -7  # dead op's offset: ignored
        pls[4, 0] = 0  # no-op
        valid = rng.random(8) < 0.9
        jc, jr = _japp_step(jc, jnp.asarray(pls), jnp.asarray(valid), jcfg,
                            kernel_backend="ref")
        tc, tr = tapp.app_step(tc, t(pls), t(valid), tcfg)
        assert_same((jc, jr), (tc, tr), f"step {step}")
        assert (tr[:3, 0][t(valid[:3])] == tst.MALFORMED).all()


# ------------------------------ engine --------------------------------------

def test_tx_through_engine_with_client_retries():
    """The twin of tests/test_tx_engine.py on the port: clients retry
    DEFERRED transactions until all commit; the chain converges to a
    serial order, replicas equal, every transaction in the log."""
    cfg = ttx.TxConfig(num_keys=64, val_words=2, max_ops=3, chain_len=2,
                       log_capacity=256)
    w = tapp.request_words(cfg)
    ecfg = teng.EngineConfig(num_queues=2, capacity=16, req_words=w,
                             resp_words=w, budget=8)
    state = teng.make(ecfg, ttx.make_chain(cfg, device="cpu"))
    assert state.req.entries.device.type == "cpu"
    app = teng.bind_app(tapp.app_step, cfg, ecfg)

    def mk_tx(ops):
        p = np.zeros(w, np.int32)
        p[0] = len(ops)
        for j, (off, val) in enumerate(ops):
            base = 1 + j * (1 + cfg.val_words)
            p[base] = off
            p[base + 1: base + 1 + cfg.val_words] = val
        return p

    txs = [
        [(7, (1, 1)), (3, (2, 2))],
        [(7, (3, 3))],
        [(9, (4, 4))],
        [(7, (5, 5)), (9, (6, 6))],
        [(11, (7, 7))],
    ]
    clients = [trb.HostClient(i, 16, w) for i in range(2)]
    pending = {0: [], 1: []}
    outstanding = list(enumerate(txs))
    committed = set()
    serial_ref = {}
    for ops in txs:
        for off, val in ops:
            serial_ref[off] = val
    ticks = 0
    while len(committed) < len(txs) and ticks < 60:
        inject_q, inject_p, used, sent = [], [], set(), set()
        for i, ops in outstanding:
            c = clients[i % 2]
            if c.queue_id in used or not c.can_send():
                continue
            inject_q.append(c.queue_id)
            inject_p.append(mk_tx(ops))
            pending[c.queue_id].append(i)
            c.note_sent()
            used.add(c.queue_id)
            sent.add(i)
        if inject_q:
            state = teng.inject(state, torch.tensor(inject_q, dtype=torch.int32),
                                t(np.stack(inject_p)))
        outstanding = [(i, o) for i, o in outstanding if i not in sent]
        state, _ = teng.engine_step(state, app, ecfg)
        pay, counts, state = teng.drain_responses(state, 8)
        for q in range(2):
            for j in range(int(counts[q])):
                clients[q].note_received()
                i = pending[q].pop(0)
                status = int(pay[q, j, 0])
                if status == tapp.RESP_COMMITTED:
                    committed.add(i)
                elif status == tapp.RESP_DEFERRED:
                    outstanding.append((i, txs[i]))
        ticks += 1
    assert len(committed) == len(txs), f"only {sorted(committed)} committed"
    store = state.app.store.numpy()
    np.testing.assert_array_equal(store[0], store[1])
    for off in (3, 9, 11):
        assert tuple(store[0][off]) == tuple(serial_ref[off])
    assert tuple(store[0][7]) in {(1, 1), (3, 3), (5, 5)}
    assert int(state.app.log_tail[0]) == len(txs)


def _engine_run(side, rounds=8, steps=2, seed=4):
    """Seeded inject / run_steps / drain rounds through one engine + TX
    chain: conflicts on few offsets, MALFORMED rows, a dead replica from
    round 3. Returns the final state and every drained response."""
    kw = dict(num_keys=32, val_words=2, max_ops=3, chain_len=3,
              log_capacity=8)
    mod_e, mod_t, mod_a = ((jeng, jtx, japp) if side == "jax"
                           else (teng, ttx, tapp))
    cfg = mod_t.TxConfig(**kw)
    w = mod_a.request_words(cfg)
    ecfg = mod_e.EngineConfig(num_queues=4, capacity=16, req_words=w,
                              resp_words=w, budget=8, kernel_backend="ref")
    if side == "jax":
        state = jeng.make(ecfg, jtx.make_chain(cfg))
        app = jeng.bind_app(japp.app_step, cfg, ecfg)
        run = jax.jit(lambda s: jeng.run_steps(s, app, ecfg, steps))
        drain = jax.jit(lambda s: jeng.drain_responses(s, 8))
        arr = jnp.asarray
    else:
        state = teng.make(ecfg, ttx.make_chain(cfg, device="cpu"))
        app = teng.bind_app(tapp.app_step, cfg, ecfg)
        run = lambda s: teng.run_steps(s, app, ecfg, steps)  # noqa: E731
        drain = lambda s: teng.drain_responses(s, 8)  # noqa: E731
        arr = t
    r = np.random.default_rng(seed)
    out = []
    for i in range(rounds):
        if i == 3:  # kill replica 1: the chain shortens around it
            live = np.array([True, False, True])
            state = state._replace(app=state.app._replace(live=arr(live)))
        n = int(r.integers(1, 5))
        qids = r.choice(4, size=n, replace=False).astype(np.int32)
        pls = _tx_batch(cfg, n, r, offset_space=6, dup=0.3)
        if r.random() < 0.5:
            pls[0, 0] = cfg.max_ops + 1  # MALFORMED
        state = mod_e.inject(state, arr(qids), arr(pls))
        state, stats = run(state)
        out.append(stats)
        pay, counts, state = drain(state)
        out.append((pay, counts))
    return state, out


def test_engine_tx_run_matches_jax_ref():
    js, jout = _engine_run("jax")
    ts, tout = _engine_run("torch")
    assert_same((js, jout), (ts, tout))
    assert int(ts.served) > 0 and int(ts.app.log_tail[0]) > 0
    assert int(ts.app.log_tail[1]) < int(ts.app.log_tail[0])  # dead froze


def test_interop_carries_a_tx_engine_state_both_ways():
    """A TX EngineState crosses JAX -> port -> numpy whole, every array
    copied (the port's in-place commits never write JAX's buffers)."""
    js, _ = _engine_run("jax", rounds=3)
    d = interop.to_numpy(js)
    ts = interop.engine_state_from_numpy(
        d, "cpu", app_from_numpy=interop.replica_state_from_numpy)
    assert isinstance(ts.app, ttx.ReplicaState)
    assert_same(js, ts)
    before = np.array(js.app.store)
    ts.app.store.fill_(7)
    np.testing.assert_array_equal(np.asarray(js.app.store), before)
    assert_same(d, interop.to_numpy(interop.engine_state_from_numpy(
        d, "cpu", app_from_numpy=interop.replica_state_from_numpy)))
    jrep = jax.tree_util.tree_map(lambda x: x[0], js.app)
    assert_same(jrep, interop.replica_state_from_numpy(
        interop.to_numpy(jrep), "cpu"))


def test_tx_kernels_take_cuda_tensors_only():
    """On the CPU, ``cuda`` raises and the wrappers refuse CPU tensors; the
    plain versions run only because the tensors lie on the CPU."""
    from repro_torch.kernels import tx_commit as ttc

    cfg = ttx.TxConfig(num_keys=8, val_words=2, max_ops=2, chain_len=2,
                       log_capacity=4)
    chain = ttx.make_chain(cfg, device="cpu")
    batch = torch.zeros((1, ttx.tx_words(cfg)), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ttx.chain_commit_local(chain, batch, cfg, kernel_backend="cuda")
    plan = ttx.plan_commit(batch, cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ttc.commit_chain(chain.log, chain.store, plan.batch, plan.values,
                         torch.zeros((2, 1), dtype=torch.int32),
                         plan.store_rows)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ttx.replica_commit(ttx.make_replica(cfg, device="cpu"), plan,
                           kernel_backend="cuda")
