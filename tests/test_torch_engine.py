"""The PyTorch port's request engine against the JAX package, bit for bit:
rings, cpoll, the scheduler, and the request half of the engine step,
compared state for state after every operation over seeded sequences."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cpoll as jcp
from repro.core import engine as jeng
from repro.core import ringbuf as jrb
from repro.core import scheduler as jsched
from repro_torch.core import cpoll as tcp
from repro_torch.core import engine as teng
from repro_torch.core import ringbuf as trb
from repro_torch.core import scheduler as tsched
from repro_torch.core import status as tst
from torch_port_helpers import assert_same, t

I32 = jnp.int32
# the JAX side runs jitted (eager JAX dispatch is what would dominate)
_enqueue = jax.jit(jrb.enqueue)
_pop = jax.jit(jrb.pop)
_gather = jax.jit(jrb.gather_batch, static_argnums=3)
_schedule = jax.jit(jsched.schedule, static_argnums=2)
_inject = jax.jit(jeng.inject, static_argnames="with_accepted")
_drain = jax.jit(jeng.drain_responses, static_argnums=1)


def _both(x, dtype=np.int32):
    x = np.asarray(x, dtype)
    return jnp.asarray(x), t(x)


# ------------------------------ ringbuf ------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_ring_sequence_matches_jax(seed):
    """Random enqueue / gather / pop waves on small rings: wrap-around,
    credit rejection (full rings) and masked entries."""
    rng = np.random.default_rng(seed)
    q, cap, w = 3, 4, 2
    js, ts = jrb.make(q, cap, w), trb.make(q, cap, w, device="cpu")
    assert_same(js, ts)
    for it in range(25):
        n = int(rng.integers(1, q + 1))
        qids, tq = _both(rng.choice(q, n, replace=False))
        pl, tp = _both(rng.integers(-9, 99, (n, w)))
        mk, tm = _both(rng.random(n) < 0.8, bool)
        js, jok = _enqueue(js, qids, pl, mk)
        ts, tok = trb.enqueue(ts, tq, tp, tm)
        assert_same((js, jok), (ts, tok), f"enqueue{it}")
        assert_same(jrb.available(js), trb.available(ts))
        assert_same(jrb.free_slots(js), trb.free_slots(ts))
        if it % 2:
            avail = np.asarray(jrb.available(js))
            counts = np.minimum(avail, rng.integers(0, cap + 1, q))
            jids, tids = _both(rng.permutation(q))
            jc, tc = _both(counts[np.asarray(jids)])
            budget = 5
            assert_same(_gather(js, jids, jc, budget),
                        trb.gather_batch(ts, tids, tc, budget), f"gather{it}")
            offs = rng.integers(0, cap, q)
            assert_same(jrb.peek(js, jids, jnp.asarray(offs, I32)),
                        trb.peek(ts, tids, t(offs.astype(np.int32))))
            js, ts = _pop(js, jids, jc), trb.pop(ts, tids, tc)
            assert_same(js, ts, f"pop{it}")


def test_enqueue_duplicate_queue_ids_raise_like_jax():
    js, ts = jrb.make(2, 4, 1), trb.make(2, 4, 1, device="cpu")
    q, tq = _both([1, 1])
    p, tp = _both([[5], [6]])
    with pytest.raises(ValueError, match="SPSC"):
        jrb.enqueue(js, q, p)
    with pytest.raises(ValueError, match="SPSC"):
        trb.enqueue(ts, tq, tp)
    # a masked-out duplicate is no violation, on both sides
    m, tm = _both([True, False], bool)
    assert_same(jrb.enqueue(js, q, p, m), trb.enqueue(ts, tq, tp, tm))


def test_host_client_flow_control():
    c = trb.HostClient(0, 2, 4)
    assert c.can_send(2) and not c.can_send(3)
    c.note_sent(2)
    assert not c.can_send() and c.in_flight == 2
    c.note_received()
    assert c.can_send() and c.in_flight == 1


# ------------------------------ cpoll --------------------------------------

def test_cpoll_matches_jax():
    rng = np.random.default_rng(3)
    q = 5
    js, ts = jcp.make(q), tcp.make(q, device="cpu")
    for it in range(12):
        ids, tids = _both(rng.integers(0, q, 6))  # repeats coalesce
        c, tc = _both(rng.integers(0, 4, 6))
        js, ts = jcp.doorbell(js, ids, c), tcp.doorbell(ts, tids, tc)
        assert_same(js, ts, f"doorbell{it}")
        if it % 3 == 2:
            (jn, js), (tn, ts) = jcp.cpoll(js), tcp.cpoll(ts)
            assert_same((jn, js), (tn, ts), f"cpoll{it}")
        else:
            ids, tids = _both(np.arange(q))
            c, tc = _both(rng.integers(0, 2, q))
            js = jcp.cpoll_partial(js, ids, c)
            ts = tcp.cpoll_partial(ts, tids, tc)
            assert_same(js, ts, f"partial{it}")
    assert tcp.bytes_scanned_cpoll(q) == jcp.bytes_scanned_cpoll(q)
    assert (tcp.bytes_scanned_polling(q, 8, 24)
            == jcp.bytes_scanned_polling(q, 8, 24))


# ------------------------------ scheduler ----------------------------------

@pytest.mark.parametrize("q,budget", [(4, 3), (8, 32), (5, 256)])
def test_schedule_matches_jax(q, budget):
    rng = np.random.default_rng(q * budget)
    js, ts = jsched.make(q), tsched.make(q, device="cpu")
    for it in range(10):
        av, tav = _both(rng.integers(-2, 3 * budget // q + 3, q))
        jt, js = _schedule(js, av, budget)
        tt, ts = tsched.schedule(ts, tav, budget)
        assert_same((jt, js), (tt, ts), f"schedule{it}")
        assert int(tt.sum()) <= budget
    assert_same(jsched.selected_queues(jt), tsched.selected_queues(tt))


def test_shed_plan_matches_jax():
    rng = np.random.default_rng(9)
    for quota in (0, 1, 3):
        d, td = _both(rng.integers(-2, 8, (4, 6)))
        v, tv = _both(rng.random((4, 6)) < 0.8, bool)
        now, tnow = _both(4)
        assert_same(jsched.shed_plan(d, v, now, quota),
                    tsched.shed_plan(td, tv, tnow, quota), f"quota{quota}")


# ------------------------------ engine -------------------------------------

def _japp(app, payloads, valid):
    return app + jnp.sum(valid.astype(I32)), payloads * 3 + 1


def _tapp(app, payloads, valid):
    return app + torch.sum(valid.to(torch.int32)).to(torch.int32), payloads * 3 + 1


@pytest.mark.parametrize("deadline_word", [-1, 1])
def test_engine_request_half_matches_jax(deadline_word):
    """Seeded inject / step / drain on small rings: wrap, a response ring
    left full (backpressure), rejected injections, and — with a deadline
    word — the shed phase answering TIMEOUT and SHED. Every EngineState
    field and every stats entry must match after each step."""
    cfg = dict(num_queues=3, capacity=4, req_words=3, resp_words=3, budget=4,
               deadline_word=deadline_word)
    jcfg, tcfg = jeng.EngineConfig(**cfg), teng.EngineConfig(**cfg)
    js = jeng.make(jcfg, jnp.zeros((), I32))
    ts = teng.make(tcfg, torch.zeros((), dtype=torch.int32))
    assert_same(js, ts)
    step = jax.jit(lambda s: jeng.engine_step(s, _japp, jcfg))
    rng = np.random.default_rng(5 + deadline_word)
    nacks = 0
    for it in range(24):
        for _ in range(int(rng.integers(0, 3))):
            n = int(rng.integers(1, 4))
            qids, tq = _both(rng.choice(3, n, replace=False))
            pl = rng.integers(1, 50, (n, 3))
            pl[:, 1] = rng.integers(-1, it + 4, n)  # deadline (<= 0: none)
            pl, tp = _both(pl)
            js, jacc = _inject(js, qids, pl, with_accepted=True)
            ts, tacc = teng.inject(ts, tq, tp, with_accepted=True)
            assert_same((js, jacc), (ts, tacc), f"inject{it}")
        js, jstats = step(js)
        ts, tstats = teng.engine_step(ts, _tapp, tcfg)
        assert_same((js, jstats), (ts, tstats), f"step{it}")
        if it % 4 != 3 and it < 16:  # later steps leave the response ring full
            m = 1 + 2 * int(rng.integers(0, 2))
            jd, td = _drain(js, m), teng.drain_responses(ts, m)
            assert_same(jd, td, f"drain{it}")
            js, ts = jd[2], td[2]
            nacks += int(tst.is_nack(td[0][..., 0]).sum())
    assert int(ts.served) > 0
    assert int(trb.free_slots(ts.resp).min()) == 0  # backpressure reached
    if deadline_word >= 0:
        assert int(ts.timed_out) + int(ts.shed) > 0 and nacks > 0


def test_run_steps_matches_jax():
    """``run_steps`` stacks the per-step stats to shape (n,), as JAX's scan."""
    cfg = dict(num_queues=2, capacity=8, req_words=2, resp_words=2, budget=3)
    jcfg, tcfg = jeng.EngineConfig(**cfg), teng.EngineConfig(**cfg)
    js = jeng.make(jcfg, jnp.zeros((), I32))
    ts = teng.make(tcfg, torch.zeros((), dtype=torch.int32), device="cpu")
    for i in range(4):
        q, tq = _both([0, 1])
        p, tp = _both([[i, 1], [i, 2]])
        js, ts = jeng.inject(js, q, p), teng.inject(ts, tq, tp)
    js, jstats = jeng.run_steps(js, _japp, jcfg, 3)
    ts, tstats = teng.run_steps(ts, _tapp, tcfg, 3)
    assert_same((js, jstats), (ts, tstats))
    assert tstats["served"].shape == (3,)
