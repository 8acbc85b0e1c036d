"""Durability of the recurrent families on the dense engine, against the
JAX package: rwkv6-1.6b (ssm, attention-free) and hymba-1.5b (hybrid:
attention in a window beside a Mamba branch, prompts past its reduced
window of 8), reduced and in f32, with JAX's parameters carried across by
``interop.lm_params_from_numpy`` and the same seeded prompts in both.

Both packages classify such a state as opaque and write full snapshots
only. Held here: the flush kinds and steps under ``full`` and
``adaptive``; the state at each flush (integer leaves bit for bit, the
recurrent states and ring caches within the dense engine's 1e-5); each
package's recovery of the other's directory, equal to its own recovery of
it on every leaf; a crash in the port between two flushes, recovered and
run on, equal to its never-crashed twin; and the launcher's
``--snapshot-dir`` / ``--recover`` path.
"""
from __future__ import annotations

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import engine as jeng
from repro.fault import recovery as jfrec
from repro.launch.serve import build_engine as jbuild_engine
from repro.models import init_params as jinit_params
from repro.parallel.sharding import local_context as jlocal_context
from repro_torch import interop
from repro_torch.configs import get_config, reduced
from repro_torch.core import engine as teng
from repro_torch.fault import recovery as tfrec
from repro_torch.launch import serve
from repro_torch.parallel.sharding import local_context
from torch_port_helpers import assert_same

ARCHS = ("rwkv6-1.6b", "hymba-1.5b")
PROMPT_LEN = {"hymba-1.5b": 12}  # past the reduced window of 8
G = 8
N_REQ, QUEUES = 6, 2
FLUSH_EVERY = 3
CRASH_AT = 7  # a step between the flushes at 6 and 9
MODES = ("full", "adaptive")
POOL_TOL = 1e-5  # tests/test_torch_lm_engine.py


def _ecfg(mod, arch):
    p = PROMPT_LEN.get(arch, 8)
    return mod.LMEngineConfig(num_queues=QUEUES, capacity=8, prompt_len=p,
                              gen_len=G, slots=3, admit_per_step=2,
                              cache_len=p + G + 2)


class _Setup:
    """Both packages' engines for ``arch`` from one set of parameters."""

    def __init__(self, arch):
        self.arch = arch
        self.jcfg = jreduced(jget_config(arch)).replace(dtype="float32")
        self.tcfg = reduced(get_config(arch)).replace(dtype="float32")
        # jitted: the same seeded init in half the time of eager dispatch
        self.jparams = jax.jit(lambda key: jinit_params(
            key, self.jcfg, jlocal_context()))(jax.random.key(0))
        self.tparams = interop.lm_params_from_numpy(
            interop.to_numpy(self.jparams), "cpu")
        rng = np.random.default_rng(5)
        p = PROMPT_LEN.get(arch, 8)
        self.prompts = rng.integers(1, self.jcfg.vocab_size,
                                    (N_REQ, p)).astype(np.int32)
        self.caps = rng.integers(G // 2, G + 1, N_REQ).astype(np.int32)

    def jax_engine(self):
        return jbuild_engine(self.jcfg, jlocal_context(),
                             _ecfg(jeng, self.arch), self.jparams)

    def port_engine(self):
        return serve.build_engine(self.tcfg, local_context(),
                                  _ecfg(teng, self.arch), self.tparams,
                                  "cpu")

    def inject_jax(self, state):
        for lo in range(0, N_REQ, QUEUES):
            sl = slice(lo, lo + QUEUES)
            state = jeng.lm_inject(
                state, jnp.arange(QUEUES, dtype=jnp.int32),
                jnp.asarray(self.prompts[sl]),
                gen_caps=jnp.asarray(self.caps[sl]))
        return state

    def inject_port(self, state):
        for lo in range(0, N_REQ, QUEUES):
            sl = slice(lo, lo + QUEUES)
            state = teng.lm_inject(state, np.arange(QUEUES, dtype=np.int32),
                                   self.prompts[sl], gen_caps=self.caps[sl])
        return state


def _managers(mod, root, tag):
    return {mode: mod.DurabilityManager(mod.DurabilityConfig(
        str(root / f"{tag}_{mode}"), every=FLUSH_EVERY, mode=mode,
        snapshot_every=2 * FLUSH_EVERY)) for mode in MODES}


@pytest.fixture(scope="module", params=ARCHS)
def timeline(request, tmp_path_factory):
    """JAX's and the port's dense engines side by side until every request
    is answered, each flushed every FLUSH_EVERY steps by one manager per
    mode. Keeps both states at each flush (numpy) and the port's final
    state."""
    su = _Setup(request.param)
    root = tmp_path_factory.mktemp(request.param)
    jstep, js = su.jax_engine()
    tstep, ts = su.port_engine()
    js, ts = su.inject_jax(js), su.inject_port(ts)
    jm, tm = _managers(jfrec, root, "jax"), _managers(tfrec, root, "port")
    at_flush = {}
    for t in range(1, 100):
        js, ts = jstep(js), tstep(ts)
        if t % FLUSH_EVERY == 0:
            for mode in MODES:
                jm[mode].flush(js)
                tm[mode].flush(ts)
            at_flush[t] = (interop.to_numpy(js), interop.to_numpy(ts))
        done = int(js.completed), int(ts.completed)
        if N_REQ in done:
            break
    assert done == (N_REQ, N_REQ), done
    for m in (*jm.values(), *tm.values()):
        m.wait()
    return dict(setup=su, root=root, jm=jm, tm=tm, at_flush=at_flush,
                steps=t, port_final=interop.to_numpy(ts))


def _close(jtree, ttree, path="state"):
    """Integer leaves bit for bit; float leaves within POOL_TOL."""
    if isinstance(jtree, dict):
        assert jtree.keys() == ttree.keys(), path
        for k in jtree:
            _close(jtree[k], ttree[k], f"{path}.{k}")
        return
    assert jtree.dtype == ttree.dtype and jtree.shape == ttree.shape, path
    if jtree.dtype.kind == "f":
        np.testing.assert_allclose(ttree, jtree, rtol=POOL_TOL,
                                   atol=POOL_TOL, err_msg=path)
    else:
        np.testing.assert_array_equal(ttree, jtree, err_msg=path)


def test_flush_kinds_and_steps_match_jax(timeline):
    """The same flushes in both packages under both modes: all full, since
    the dense recurrent state is opaque to the delta diff."""
    steps = sorted(timeline["at_flush"])
    assert len(steps) >= 3
    for mode in MODES:
        jm, tm = timeline["jm"][mode], timeline["tm"][mode]
        jrec = [(r.step, r.kind, r.bytes, r.committed) for r in jm.records]
        trec = [(r.step, r.kind, r.bytes, r.committed) for r in tm.records]
        assert jrec == trec, mode
        assert [r[0] for r in trec] == steps
        assert {r[1] for r in trec} == {"full"} and all(r[3] for r in trec)
        for k in ("fsyncs", "wal_records", "disk_bytes", "gc_removed"):
            assert jm.stats()[k] == tm.stats()[k], (mode, k)


def test_state_at_each_flush_matches_jax(timeline):
    leaves = timeline["at_flush"].values()
    for jstate, tstate in leaves:
        _close(jstate, tstate)
    # the recurrent state is really there to compare
    jstate, _ = timeline["at_flush"][FLUSH_EVERY]
    layers = jstate["decode"]["layers"]
    assert "s" in layers and np.abs(layers["s"]).max() > 0


@pytest.mark.parametrize("mode", MODES)
def test_port_recovers_jax_directory_bit_for_bit(timeline, tmp_path, mode):
    su = timeline["setup"]
    src = timeline["root"] / f"jax_{mode}"
    dj, dt = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(src, dj)
    shutil.copytree(src, dt)
    jout, jcov = jfrec.recover(str(dj), su.jax_engine()[1])
    stats = {}
    tout, tcov = tfrec.recover(str(dt), su.port_engine()[1], stats=stats)
    last = max(timeline["at_flush"])
    assert jcov == tcov == last
    assert stats["snapshot_step"] == last and stats["wal_records"] == 0
    assert_same(jout, tout)
    assert_same(timeline["at_flush"][last][0], tout)


@pytest.mark.parametrize("mode", MODES)
def test_jax_recovers_port_directory_bit_for_bit(timeline, tmp_path, mode):
    su = timeline["setup"]
    src = timeline["root"] / f"port_{mode}"
    dj, dt = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(src, dj)
    shutil.copytree(src, dt)
    jout, jcov = jfrec.recover(str(dj), su.jax_engine()[1])
    tout, tcov = tfrec.recover(str(dt), su.port_engine()[1])
    last = max(timeline["at_flush"])
    assert jcov == tcov == last
    assert_same(jout, tout)
    assert_same(timeline["at_flush"][last][1], tout)


def _answers(state):
    """Each queue's responses as (count, tokens), after checking that
    every ring holds one answer per request sent to it."""
    avail = state["resp"]["tail"] - state["resp"]["head"]
    assert avail.tolist() == [N_REQ // QUEUES] * QUEUES
    ents = state["resp"]["entries"]
    return [[(int(e[0]), e[1:1 + int(e[0])].tolist())
             for e in ents[q][:N_REQ // QUEUES]] for q in range(QUEUES)]


def test_port_crash_recovers_to_its_never_crashed_twin(timeline, tmp_path):
    """Kill the port's run between two flushes, recover into a fresh state
    and run on: the recovered state is the one flushed at the covered
    step, and the streams and final state equal the never-crashed twin's
    bit for bit, each request answered once."""
    su = timeline["setup"]
    step, state = su.port_engine()
    state = su.inject_port(state)
    mgr = tfrec.DurabilityManager(tfrec.DurabilityConfig(
        str(tmp_path), every=FLUSH_EVERY, mode="adaptive"))
    for t in range(1, CRASH_AT + 1):
        state = step(state)
        if t % FLUSH_EVERY == 0:
            mgr.flush(state)
    mgr.wait()
    assert [r.step for r in mgr.committed()] == [3, 6]
    del state  # the crash: nothing of the live state survives
    step, fresh = su.port_engine()
    state, covered = tfrec.recover(str(tmp_path), fresh)
    assert covered == 6
    assert_same(timeline["at_flush"][6][1], state)
    for _ in range(covered, timeline["steps"]):
        state = step(state)
    assert int(state.completed) == N_REQ
    twin = timeline["port_final"]
    assert_same(twin, state)
    assert _answers(interop.to_numpy(state)) == _answers(twin)
    caps = sorted(n for q in _answers(twin) for n, _ in q)
    assert caps == sorted(su.caps.tolist())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_snapshots_and_recovers(tmp_path, capsys, arch):
    """``launch.serve --device cpu --arch {arch} --snapshot-dir D``, then
    the same with ``--recover``: it restores the last committed snapshot
    and makes progress (in process; the argument path is the CLI's)."""
    base = ["--device", "cpu", "--arch", arch, "--requests", "6",
            "--gen-len", "4", "--queues", "2", "--vary-caps",
            "--snapshot-dir", str(tmp_path), "--snapshot-every", "3",
            "--durability-mode", "adaptive"]
    assert serve.main(base) == 6
    out = capsys.readouterr().out
    assert "snapshots:" in out and "0 WAL records" in out
    assert serve.main(base + ["--recover"]) > 0
    out = capsys.readouterr().out
    assert "recovered engine state at step" in out
    covered = int(out.split("recovered engine state at step ")[1].split()[0])
    assert covered > 0
