"""The port's fault soak (``repro_torch/fault/soak.py``) against the JAX
package's: the seeded soak driver gives the same counters, status counts,
responses, resubmits and chain, bit for bit; ``run_soak``'s acceptance set
holds; ``run_overload`` bounds p99 with shedding and lets it grow without;
and on random seeds a short soak matches JAX's.

Both drivers draw workload and faults from ``np.random.default_rng``, so
the same seed gives the same requests and the same fault schedule.
"""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.fault import soak as jsoak
from repro_torch.fault import inject as tinj
from repro_torch.fault import soak as tsoak
from torch_port_helpers import assert_same

_SAME = ("counters", "status_counts", "responses", "resubmits", "requests",
         "engine", "monitor_events", "sojourns")


def _same_drive(seed, steps, kill, revive):
    j = jsoak._drive(seed, steps, kill, revive)
    t = tsoak._drive(seed, steps, kill, revive, device="cpu")
    for k in _SAME:
        assert j[k] == t[k], k
    np.testing.assert_array_equal(j["oracle_store"], t["oracle_store"])
    assert_same(j["chain"], t["chain"])
    return t


def test_drive_seed7_matches_jax():
    t = _same_drive(7, 60, ((20, 1),), ((40, 1),))
    assert t["monitor_events"] == [("kill", 1), ("revive", 1)]
    assert t["resubmits"] >= 1


def test_run_soak_acceptance_set():
    r = tsoak.run_soak(seed=7, steps=60, device="cpu")
    assert r["responses"] == r["counters"]["landed"]
    for c in tinj.FAULT_CLASSES:
        assert r["counters"][c] >= 1
    assert sum(v for k, v in r["status_counts"].items() if k < 0) >= 1
    assert bool(r["chain"].live.all())
    assert_same(r["chain"].store[1], r["control_chain"].store[0])


def test_run_overload_sheds_to_bound_p99():
    steps, deadline = 120, 24
    on = tsoak.run_overload(seed=0, steps=steps, shed=True,
                            deadline=deadline, device="cpu")
    off = tsoak.run_overload(seed=0, steps=steps, shed=False,
                             deadline=deadline, device="cpu")
    assert off["shed"] == 0 and off["timed_out"] == 0
    assert off["p99_sojourn"] > deadline
    assert on["shed"] + on["timed_out"] > 0
    assert on["p99_sojourn"] < off["p99_sojourn"]
    assert on["p99_sojourn"] <= 1.5 * deadline + 2
    assert on["final_backlog"] < off["final_backlog"]
    # and the same numbers as the JAX package's sweep
    assert on == jsoak.run_overload(seed=0, steps=steps, shed=True,
                                    deadline=deadline)


@settings(max_examples=3, deadline=None)
@given(st.integers(0, 10 ** 6))
def test_property_soak_matches_jax(seed):
    t = _same_drive(seed, 20, ((7, 1),), ((14, 1),))
    assert t["responses"] == t["counters"]["landed"]


@pytest.mark.parametrize("app", ["tx", "kvs"])
def test_run_durability_matches_jax_arm(tmp_path, app):
    """The faultless overhead arm: same flush kinds and bytes as the JAX
    arm's (the release lag may differ: the port gates on settled
    coverage)."""
    from repro.fault import recovery as jfrec
    from repro_torch.fault import recovery as tfrec

    kw = dict(every=2, mode="adaptive", snapshot_every=8)
    j = jsoak.run_durability(seed=1, steps=24, app=app,
                             durability=jfrec.DurabilityConfig(
                                 str(tmp_path / "j"), **kw))
    t = tsoak.run_durability(seed=1, steps=24, app=app, device="cpu",
                             durability=tfrec.DurabilityConfig(
                                 str(tmp_path / "t"), **kw))
    assert t["responses"] == j["responses"] > 0
    assert t["flush_full"] >= 1 and t["flush_delta"] >= 1
    assert t["fsyncs"] < t["wal_records"]
    first = [(r.step, r.kind, r.bytes) for r in t["flush_records"]][:8]
    assert first[0][1] == "full" and all(b > 0 for _, _, b in first)


ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "fault_soak_torch.py"


def test_fault_soak_script_imports_neither_jax_nor_repro():
    bad = []
    for node in ast.walk(ast.parse(SCRIPT.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom)
                 and node.module else [])
        bad += [m for m in names
                if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_importing_fault_and_checkpoint_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.fault, repro_torch.fault.soak\n"
            "import repro_torch.checkpoint\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)


@pytest.mark.parametrize("args", [["--steps", "40"],
                                  ["--crash", "--steps", "40"],
                                  ["--crash", "--app", "lm", "--seed", "3",
                                   "--steps", "30"]])
def test_fault_soak_script_on_cpu(tmp_path, args):
    out = tmp_path / "report.json"
    subprocess.run([sys.executable, str(SCRIPT), "--device", "cpu", *args,
                    "--out", str(out)], check=True, cwd=ROOT, timeout=300,
                   capture_output=True)
    report = json.loads(out.read_text())
    assert report["device"] == "cpu"
    if "--app" in args:
        assert report["torn_segment_truncated"] and report["evictions"] >= 1
    else:
        assert report["responses"] == report["counters"]["landed"]
        assert ("crash" in report) == ("--crash" in args)
