"""The first slice of the port as a whole — the ORCA request engine serving
the KVS app — against the JAX package, bit for bit: a twin of
``examples/quickstart.py``, and seeded multi-step engine + KVS runs whose
responses and final ``EngineState`` must equal JAX's, with and without
the hot-set cache tier, against JAX's plain path and its Pallas kernels
(interpret mode)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import kvstore as jkv
from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.core import kvstore as tkv
from repro_torch.core import ringbuf as trb
from torch_port_helpers import assert_same, t


def test_quickstart_twin():
    """examples/quickstart.py on the port: every client PUTs then GETs its
    own key through rings, cpoll, the scheduler and the KVS — on the CPU,
    where the dispatcher takes the plain versions. The JAX quickstart's
    traffic gives the same responses and the same final state."""
    kw = dict(num_buckets=256, ways=4, key_words=2, val_words=4,
              pool_size=1024)
    kcfg, jkcfg = tkv.KVConfig(**kw), jkv.KVConfig(**kw)
    w = tkv.request_words(kcfg)
    ecfg = teng.EngineConfig(num_queues=4, capacity=16, req_words=w,
                             resp_words=w, budget=16)
    jecfg = jeng.EngineConfig(*ecfg)
    state = teng.make(ecfg, tkv.make(kcfg, device="cpu"))
    jstate = jeng.make(jecfg, jkv.make(jkcfg))
    app = teng.bind_app(tkv.app_step, kcfg, ecfg)
    japp = jeng.bind_app(jkv.app_step, jkcfg, jecfg._replace(
        kernel_backend="ref"))
    jstep = jax.jit(lambda s: jeng.engine_step(s, japp, jecfg))

    clients = [trb.HostClient(i, 16, w) for i in range(4)]
    rng = np.random.default_rng(0)
    keys = [(10 + i, 20 + i) for i in range(4)]
    vals = [rng.integers(0, 99, 4).astype(np.int32) for _ in range(4)]

    def request(op, i):
        payload = np.zeros(w, np.int32)
        payload[0] = op
        payload[1:3] = keys[i]
        if op == tkv.OP_PUT:
            payload[3:7] = vals[i]
        return payload

    for op in (tkv.OP_PUT, tkv.OP_GET):
        batch = np.stack([request(op, i) for i in range(4)])
        state = teng.inject(state, torch.arange(4), t(batch))
        jstate = jeng.inject(jstate, jnp.arange(4, dtype=jnp.int32),
                             jnp.asarray(batch))
        for c in clients:
            c.note_sent()
        state, stats = teng.engine_step(state, app, ecfg)
        jstate, jstats = jstep(jstate)
        assert_same((jstate, jstats), (state, stats))
        assert int(stats["served"]) == 4
        pay, counts, state = teng.drain_responses(state, 8)
        jpay, jcounts, jstate = jeng.drain_responses(jstate, 8)
        assert_same((jpay, jcounts, jstate), (pay, counts, state))
        for c, n in zip(clients, counts.tolist()):
            c.note_received(n)
    for i in range(4):
        got = pay[i, 0].numpy()
        assert got[0] == 1 and np.array_equal(got[1:5], vals[i])
        assert clients[i].in_flight == 0


def _run(side, kw, backend, rounds, steps, seed=7):
    """Seeded inject / run_steps / drain rounds through one engine + KVS
    (the shape of tests/test_kernel_dispatch.py's engine bit-for-bit
    test). Returns the final state and every drained response."""
    mod_e, mod_k = (jeng, jkv) if side == "jax" else (teng, tkv)
    kcfg = mod_k.KVConfig(**kw)
    w = mod_k.request_words(kcfg)
    ecfg = mod_e.EngineConfig(num_queues=4, capacity=16, req_words=w,
                              resp_words=w, budget=8, kernel_backend=backend)
    if side == "jax":
        state = jeng.make(ecfg, jkv.make(kcfg))
        app = jeng.bind_app(jkv.app_step, kcfg, ecfg)
        run = jax.jit(lambda s: jeng.run_steps(s, app, ecfg, steps))
        drain = jax.jit(lambda s: jeng.drain_responses(s, 8))
        arr = jnp.asarray
    else:
        state = teng.make(ecfg, tkv.make(kcfg, device="cpu"))
        app = teng.bind_app(tkv.app_step, kcfg, ecfg)
        run = lambda s: teng.run_steps(s, app, ecfg, steps)  # noqa: E731
        drain = lambda s: teng.drain_responses(s, 8)  # noqa: E731
        arr = t
    r = np.random.default_rng(seed)  # identical traffic on both sides
    out = []
    for i in range(rounds):
        n = int(r.integers(1, 5))
        qids = r.choice(4, size=n, replace=False).astype(np.int32)
        pls = np.zeros((n, w), np.int32)
        pls[:, 0] = r.integers(1, 3, n)
        pls[:, 1:3] = r.integers(1, 4, (n, 2))  # few keys: re-reads, cache hits
        pls[:, 3:7] = r.integers(0, 99, (n, 4))
        state = mod_e.inject(state, arr(qids), arr(pls))
        state, stats = run(state)
        out.append(stats)
        if i % 2:
            pay, counts, state = drain(state)
            out.append((pay, counts))
    return state, out


KV_SHAPES = {
    "nocache": dict(num_buckets=32, ways=2, key_words=2, val_words=4,
                    pool_size=64),
    "cache": dict(num_buckets=32, ways=2, key_words=2, val_words=4,
                  pool_size=64, cache_sets=4, cache_ways=2),
}


@pytest.mark.parametrize("name", sorted(KV_SHAPES))
def test_engine_kvs_run_matches_jax_ref(name):
    kw = KV_SHAPES[name]
    js, jout = _run("jax", kw, "ref", rounds=10, steps=3)
    ts, tout = _run("torch", kw, "auto", rounds=10, steps=3)
    assert_same((js, jout), (ts, tout))
    assert int(ts.served) > 0 and int(ts.app.alloc) > 0
    if kw.get("cache_sets"):
        assert int(ts.app.cache_hits) > 0


@pytest.mark.parametrize("name", sorted(KV_SHAPES))
def test_engine_kvs_run_matches_jax_pallas(name):
    """Two rounds against the Pallas kernels in interpret mode."""
    kw = KV_SHAPES[name]
    js, jout = _run("jax", kw, "pallas", rounds=2, steps=2)
    ts, tout = _run("torch", kw, "auto", rounds=2, steps=2)
    assert_same((js, jout), (ts, tout))
    # and the run continues from the carried-across state on the port
    ts2 = interop.engine_state_from_numpy(interop.to_numpy(js), "cpu")
    assert_same(ts, ts2)
