"""The LM engine inside the port's persistence domain, against the JAX
package, on the reduced f32 qwen1.5-0.5b: the host cold tier's
``state_arrays`` after the same evictions, the recovery of a JAX-written
LM directory (snapshot + dirty-page deltas + cold slabs), and the port's
LM crash soak, whose token streams must equal its never-crashed twin's.
Parameters come from the JAX side (``interop.lm_params_from_numpy``).
"""
from __future__ import annotations

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import engine as jeng
from repro.core import placement as jplace
from repro.fault import recovery as jfrec
from repro.fault import soak as jsoak
from repro.models import init_params as jinit_params
from repro.parallel.sharding import local_context as jlocal_context
from repro.serving import kv_cache as jpk
from repro_torch import interop
from repro_torch.configs import get_config, reduced
from repro_torch.core import engine as teng
from repro_torch.core import placement as tplace
from repro_torch.fault import recovery as tfrec
from repro_torch.fault import soak as tsoak
from repro_torch.parallel.sharding import local_context
from repro_torch.serving import kv_cache as tpk
from torch_port_helpers import assert_same

I32 = jnp.int32
ECFG = dict(num_queues=2, capacity=8, prompt_len=4, gen_len=6, slots=3,
            admit_per_step=2, cache_len=16, paged=True, page_size=2,
            num_pages=8, host_pages=10, expected_gen_len=3,
            kernel_backend="ref")


def _cfgs():
    jcfg = jreduced(jget_config("qwen1.5-0.5b")).replace(dtype="float32")
    tcfg = reduced(get_config("qwen1.5-0.5b")).replace(dtype="float32")
    return jcfg, tcfg


def _tiers(host_pages=6, budget_bytes=None):
    jcfg, tcfg = _cfgs()
    jecfg, tecfg = jeng.LMEngineConfig(**ECFG), teng.LMEngineConfig(**ECFG)
    jp = jeng.lm_paged_kv_config(jecfg, jcfg, jlocal_context())
    tp = teng.lm_paged_kv_config(tecfg, tcfg, local_context())
    jb = tb = None
    if budget_bytes is not None:
        jb = jplace.MemoryBudget(budget_bytes, 1 << 20)
        tb = tplace.MemoryBudget(budget_bytes, 1 << 20)
    return (jpk.HostColdTier(jp, host_pages, dtype=jnp.float32, budget=jb),
            tpk.HostColdTier(tp, host_pages, dtype=torch.float32, budget=tb),
            jp)


@pytest.mark.parametrize("budget_pages", [None, 5])
def test_cold_tier_state_arrays_match_jax(budget_pages):
    jc, tc, pcfg = _tiers()
    budget = None if budget_pages is None else budget_pages * jc.page_bytes
    if budget is not None:
        jc, tc, pcfg = _tiers(budget_bytes=budget)
    assert jc.page_bytes == tc.page_bytes
    rng = np.random.default_rng(0)
    shape = (pcfg.layers, pcfg.max_pages_per_seq, pcfg.page_size,
             pcfg.kv_heads, pcfg.head_dim)
    for op, slot, npg in (("store", 0, 2), ("store", 2, 1), ("store", 1, 3),
                          ("drop", 2, 0), ("store", 2, 2), ("store", 0, 1),
                          ("drop", 0, 0), ("store", 4, 1)):
        if op == "store":
            k = rng.normal(size=shape).astype(np.float32)
            v = rng.normal(size=shape).astype(np.float32)
            assert jc.can_accept(slot, npg) == tc.can_accept(slot, npg)
            assert jc.store(slot, k, v, npg) == tc.store(
                slot, torch.from_numpy(k), torch.from_numpy(v), npg)
        else:
            jc.drop(slot, restored=True)
            tc.drop(slot, restored=True)
        assert_same(jc.state_arrays(), tc.state_arrays())
        assert (jc.budget_refusals, jc.free, jc.pages_used) == \
            (tc.budget_refusals, tc.free, tc.pages_used)
    if budget is not None:
        assert tc.budget_refusals >= 1
        assert jc.budget.used() == tc.budget.used()
    # restore_arrays rebuilds the allocator from either package's arrays
    _, fresh, _ = _tiers(budget_bytes=budget)
    fresh.restore_arrays(jc.state_arrays())
    assert_same(jc.state_arrays(), fresh.state_arrays())
    assert (fresh.order, fresh.free, fresh.slot_pages) == \
        (tc.order, tc.free, tc.slot_pages)


def _jax_lm_directory(d, steps=14):
    """A JAX LM timeline with a cold tier, flushed as a snapshot plus
    dirty-page deltas. Returns the live state and cold arrays at the end."""
    ecfg = jeng.LMEngineConfig(**ECFG)
    cfg, ctx, step = jsoak._compiled_lm(0, ecfg)
    swap, cold, _ = jeng.make_swap_service(ecfg, cfg, ctx)
    state = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True),
                                   jeng.lm_make_paged(ecfg, cfg, ctx))
    rng = np.random.default_rng(3)
    mgr = jfrec.DurabilityManager(jfrec.DurabilityConfig(
        d, every=1, snapshot_every=1000, mode="delta", group_records=3),
        cold=cold)
    for t in range(steps):
        if t < 5:
            rows = rng.integers(1, cfg.vocab_size, (2, 4)).astype(np.int32)
            caps = rng.integers(1, 7, 2).astype(np.int32)
            state = jeng.lm_inject(state, jnp.asarray([0, 1], I32),
                                   jnp.asarray(rows), gen_caps=jnp.asarray(
                                       caps))
        state = swap(step(state))
        mgr.flush(state)
    mgr.wait()
    assert cold.evictions >= 1, "the pool never spilled to the cold tier"
    assert [r.kind for r in mgr.records][:2] == ["full", "delta"]
    return state, cold.state_arrays()


def test_port_recovers_jax_lm_directory(tmp_path):
    d = str(tmp_path / "jax")
    live, live_cold = _jax_lm_directory(d)
    shutil.copytree(d, str(tmp_path / "port"))
    jcfg, tcfg = _cfgs()
    jecfg, tecfg = jeng.LMEngineConfig(**ECFG), teng.LMEngineConfig(**ECFG)
    jp = jeng.lm_paged_kv_config(jecfg, jcfg, jlocal_context())
    tp = teng.lm_paged_kv_config(tecfg, tcfg, local_context())
    jcold = jpk.HostColdTier(jp, 10, dtype=jnp.float32)
    tcold = tpk.HostColdTier(tp, 10, dtype=torch.float32)
    jout, jcov = jfrec.recover(d, jeng.lm_make_paged(jecfg, jcfg,
                                                     jlocal_context()),
                               cold=jcold)
    stats = {}
    tout, tcov = tfrec.recover(
        str(tmp_path / "port"),
        teng.lm_make_paged(tecfg, tcfg, local_context(), "cpu"),
        cold=tcold, stats=stats)
    assert jcov == tcov == int(live.steps)
    assert stats["wal_records"] >= 1
    assert_same(jout, tout)
    assert_same(live, tout)
    assert_same(jcold.state_arrays(), tcold.state_arrays())
    assert_same(live_cold, tcold.state_arrays())
    assert (tcold.order, tcold.free, tcold.evictions) == \
        (jcold.order, jcold.free, jcold.evictions)


def test_port_lm_crash_soak_streams_equal_twin():
    jcfg, tcfg = _cfgs()
    jparams = jinit_params(jax.random.key(3), jcfg, jlocal_context())
    params = interop.lm_params_from_numpy(interop.to_numpy(jparams), "cpu")
    report = tsoak.run_lm_crash_soak(
        seed=3, steps=30, n_requests=8, device="cpu",
        model=(tcfg, local_context(), params))
    main = report["main"]
    assert main["crash"]["torn_segment_truncated"]
    assert main["evictions"] >= 1
    assert report["stats"]["fsyncs"] < report["stats"]["wal_records"]
    for q, n in main["target"].items():
        assert len(main["delivered"][q]) == n


def test_port_lm_crash_soak_plain_twin_streams_equal():
    """``twin_backend`` adds a never-crashed timeline on that backend; its
    token rows must sit at the control twin's ring positions."""
    model = tsoak.lm_soak_model(3, "cpu")
    report = tsoak.run_lm_crash_soak(
        seed=3, steps=30, n_requests=8, device="cpu", model=model,
        twin_backend="ref")
    twin, ctrl = report["twin"], report["ctrl"]
    assert set(report["seconds"]) == {"main", "ctrl", "twin"}
    for q, n in ctrl["target"].items():
        assert len(twin["delivered"][q]) == n
        assert twin["delivered"][q].keys() == ctrl["delivered"][q].keys()


def test_serve_snapshots_and_recovers_with_host_pages(tmp_path):
    """The port's launcher takes the JAX launcher's fault and durability
    flags: serve with faults and adaptive flushes, exit, then --recover
    resumes from the stream."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--device",
            "cpu", "--requests", "6", "--prompt-len", "6", "--gen-len", "4",
            "--queues", "2", "--paged", "--page-size", "2", "--num-pages",
            "12", "--host-pages", "36", "--vary-caps", "--snapshot-dir",
            str(tmp_path), "--snapshot-every", "4", "--durability-mode",
            "adaptive"]
    out = subprocess.run(base + ["--inject-faults", "5"], capture_output=True,
                         text=True, timeout=300, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "durability:" in out.stdout and "faults:" in out.stdout
    out2 = subprocess.run(base + ["--recover"], capture_output=True,
                          text=True, timeout=300, env=env, cwd=root)
    assert out2.returncode == 0, out2.stderr[-3000:]
    assert "recovered engine state at step" in out2.stdout
