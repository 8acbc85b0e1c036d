"""The port's fault injector (``repro_torch/fault/inject.py``) against the
JAX package's: one ``FaultConfig`` and seed, the same inject and tick
sequence on engine states that start equal, give equal counters, landing
histories, rings and cpoll regions, schedule events and
``reconcile_crash`` results. Both draw the schedule from
``np.random.default_rng(seed)``, so the schedules are the same draws.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core import transaction as jtx
from repro.core import tx_app as japp
from repro.fault import inject as jinj
from repro.fault import watchdog as jwd
from repro_torch import interop
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.core import engine as teng
from repro_torch.core import transaction as ttx
from repro_torch.core import tx_app as tapp
from repro_torch.fault import inject as tinj
from repro_torch.fault import watchdog as twd
from torch_port_helpers import assert_same

TX = dict(num_keys=24, val_words=2, max_ops=2, chain_len=2, log_capacity=64)


def _engines(capacity):
    jcfg, tcfg = jtx.TxConfig(**TX), ttx.TxConfig(**TX)
    w = japp.request_words(jcfg)
    kw = dict(num_queues=3, capacity=capacity, req_words=w, resp_words=w,
              budget=2, kernel_backend="ref")
    jecfg, tecfg = jeng.EngineConfig(**kw), teng.EngineConfig(**kw)
    js = jeng.make(jecfg, jtx.make_chain(jcfg))
    ts = interop.engine_state_from_numpy(
        interop.to_numpy(js), "cpu",
        app_from_numpy=interop.replica_state_from_numpy)
    japp_fn = jeng.bind_app(japp.app_step, jcfg, jecfg)
    tapp_fn = teng.bind_app(tapp.app_step, tcfg, tecfg)
    jstep = jax.jit(lambda s: jeng.engine_step(s, japp_fn, jecfg)[0])
    return js, ts, jstep, lambda s: teng.engine_step(s, tapp_fn, tecfg)[0], w


def _fault_cfg(seed, **kw):
    return dict(seed=seed, p_drop=0.1, p_dup=0.1, p_corrupt=0.1,
                p_delay=0.15, p_suppress=0.15, delay_min=1, delay_max=3,
                suppress_steps=2, kill_schedule=((3, 1), (9, 0)),
                revive_schedule=((6, 1),), **kw)


def _same_injectors(ji, ti):
    assert dict(ji.counters) == dict(ti.counters)
    assert len(ji.landed) == len(ti.landed)
    for (a, b) in zip(ji.landed, ti.landed):
        assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3]
        np.testing.assert_array_equal(a[2], b[2])
    assert [d[:2] for d in ji._delayed] == [d[:2] for d in ti._delayed]
    assert ji._doorbells == ti._doorbells
    assert ji._landed_q == ti._landed_q
    assert ji.now == ti.now and ji.in_flight == ti.in_flight


@pytest.mark.parametrize("seed,capacity", [(0, 4), (1, 8), (2, 3)])
def test_same_schedule_same_rings(seed, capacity):
    js, ts, jstep, tstep, w = _engines(capacity)
    cfgd = _fault_cfg(seed)
    ji = jinj.FaultInjector(jinj.FaultConfig(**cfgd))
    ti = tinj.FaultInjector(tinj.FaultConfig(**cfgd))
    rng = np.random.default_rng(100 + seed)
    snaps = []
    for step in range(12):
        for _ in range(4):
            q = int(rng.integers(0, 3))
            payload = rng.integers(0, 20, w).astype(np.int64)
            payload[0] = 1 + int(rng.integers(0, 2))
            js, jacc = ji.inject(js, q, payload, tag=(step, q))
            ts, tacc = ti.inject(ts, q, payload, tag=(step, q))
            assert jacc == tacc
        js, jev = ji.tick(js)
        ts, tev = ti.tick(ts)
        assert jev == tev
        _same_injectors(ji, ti)
        assert_same(js.req, ts.req)
        assert_same(js.cpoll, ts.cpoll)
        snaps.append((js, tckpt.host_copy(ts)))
        if step % 2:
            js, ts = jstep(js), tstep(ts)
            assert_same(js, ts)
    assert ji.counters["rejected"] or capacity > 3
    assert sum(ji.counters[c] for c in jinj.FAULT_CLASSES) > 0

    # crash: roll the engine back to an earlier step, reconcile the wire
    jsnap, tsnap = snaps[7]
    js2, jwiped = ji.reconcile_crash(jsnap)
    ts2, twiped = ti.reconcile_crash(tsnap)
    assert [(s, q, t) for s, q, _, t in jwiped] == \
        [(s, q, t) for s, q, _, t in twiped]
    for a, b in zip(jwiped, twiped):
        np.testing.assert_array_equal(a[2], b[2])
    assert_same(js2, ts2)
    _same_injectors(ji, ti)


def test_schedule_draws_are_numpy_default_rng():
    """Same seed, same class sequence: the schedule is a pure function of
    ``np.random.default_rng(seed)`` in both packages."""
    js, ts, _, _, w = _engines(64)
    cfgd = _fault_cfg(42)
    ji = jinj.FaultInjector(jinj.FaultConfig(**cfgd))
    ti = tinj.FaultInjector(tinj.FaultConfig(**cfgd))
    assert [ji._classify() for _ in range(200)] == \
        [ti._classify() for _ in range(200)]
    assert ji.rng.bit_generator.state == ti.rng.bit_generator.state


def test_nack_error_and_retry_helpers_match():
    e = tinj.NackError(-3, "shed")
    assert twd.is_transient(e) == jwd.is_transient(jinj.NackError(-3)) \
        is True
    assert e.status == -3
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise tinj.NackError(-1)
        return "ok"

    assert tinj.request_with_retries(flaky, retries=4, backoff=0.0) == "ok"
    assert len(calls) == 3
    with pytest.raises(ValueError):
        tinj.request_with_retries(
            lambda: (_ for _ in ()).throw(ValueError("bad")), backoff=0.0)


def test_straggler_detector_matches():
    times = [1.0, 1.1, 0.9, 1.0, 3.5, 1.0, 4.0, 4.2, 4.5, 1.0]
    jd, td = jwd.StragglerDetector(), twd.StragglerDetector()
    assert [jd.observe(t) for t in times] == [td.observe(t) for t in times]
    assert jd.events == td.events


def test_inject_on_lm_engine_state():
    """The injector works against any state with ``req`` and ``cpoll``
    rings, the LM engine's included (the serve launcher's fault path)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.parallel.sharding import local_context

    cfg = reduced(get_config("qwen1.5-0.5b")).replace(dtype="float32")
    ecfg = teng.LMEngineConfig(num_queues=2, capacity=2, prompt_len=4,
                               gen_len=4, slots=2, paged=True, page_size=2)
    state = teng.lm_make_paged(ecfg, cfg, local_context(), "cpu")
    fi = tinj.FaultInjector(tinj.FaultConfig(seed=3, p_suppress=1.0))
    state, ok = fi.inject(state, 1, np.arange(5, dtype=np.int32))
    assert ok and int(state.req.tail[1]) == 1
    assert int(state.cpoll.pointer_buffer[1]) == 0  # doorbell withheld
    for _ in range(2):
        state, _ = fi.tick(state)
    assert int(state.cpoll.pointer_buffer[1]) == 1
