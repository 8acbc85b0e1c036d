"""The port's LM engine over data ranks (and data x model ranks) on gloo
ranks on the CPU, held against the JAX package's one engine under GSPMD.

JAX's references run once for the module in one subprocess with 8 forced
host devices on ``AxisType.Auto`` meshes (as ``test_torch_tp.py``'s):
each case's params from JAX's ``init_params`` at the mesh's padded head
plan, placed by ``param_specs``, then ``launch.serve.build_engine``
(dense or paged; the swap service's ``make_swap_service`` before every
step) over ``torch_dp_engine_ranks``' requests until all complete, the
state walked after every step. The port's ranks (one launch a mesh)
run the same engines on their blocks while JAX computes, from the params
it writes first.

JAX's state is one array a leaf, its decode rows split over the data
axis where it divides the slots (``decode_state_specs``). A rank holds
every integer of the engine whole (rings, scheduler, slots, responses,
the page table, free list, lengths and residency) and its block of the
decode state: its rows (all of them where the data ranks do not divide
the slots), its kv heads, its recurrent-state heads where the spec
splits them, and in the paged pool its slots' pages.

Checks, at every step: every integer equal to JAX's (the decode state's
integer rows: the rank's rows of JAX's); the decode state's float rows
within 2e-5 (rtol and atol, as ``test_torch_tp.py``: the model-axis sums
add in other orders than XLA's) of the rank's block of JAX's; the pool's
live tokens of the rank's slots within 2e-5 of JAX's; for the swap
service at least one eviction and one restore, the host allocator equal
to JAX's and the parked pages of the rank's slots within 2e-5 of JAX's
slabs; and a rank's flush restores its state and tier bit for bit."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import torch_dp_engine_ranks as dpr
from repro_torch.parallel import collectives as coll

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANK_TIMEOUT = 120  # s, each collective's bound (and the launch's, + 60)
THREADS = 1
TOL = 2e-5
JAX_TIMEOUT = 600  # s
POOL = ("/decode/k_pages", "/decode/v_pages")
COLD_SLABS = ("k", "v")

JAX_REFS = r'''
import json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, AxisType

sys.path.insert(0, os.path.dirname(sys.argv[3]))
import torch_dp_engine_ranks as dpr  # the case table and driver loop
from repro.configs import get_config, reduced
from repro.core import engine as eng
from repro.launch.mesh import make_context
from repro.launch.serve import build_engine
from repro.models import model as M
from repro.parallel.sharding import param_specs

out, cases = sys.argv[1], json.loads(sys.argv[2])
devs = np.array(jax.devices())
assert len(devs) == 8, devs
res = {}


def mesh_of(shape):
    n = shape[0] * shape[1]
    return Mesh(devs[:n].reshape(shape), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)


def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/".join(str(k.key) for k in path)] = np.asarray(leaf)


def walk(node, prefix):
    if hasattr(node, "_fields"):
        for f in node._fields:
            walk(getattr(node, f), f"{prefix}/{f}")
    elif isinstance(node, dict):
        for k, v in node.items():
            walk(v, f"{prefix}/{k}")
    else:
        res[prefix] = np.array(node)


def setup(case, spec):
    cfg = reduced(get_config(spec["arch"])).replace(
        dtype="float32", **spec.get("cfg", {}))
    mesh = mesh_of(tuple(spec["mesh"]))
    ctx = make_context(mesh, cfg)._replace(
        ep_shardmap=spec.get("ep_shardmap", False))
    return cfg, mesh, ctx, M.init_params(jax.random.key(0), cfg, ctx)


for case, spec in cases.items():
    flat(setup(case, spec)[3], case + "/params/")
np.savez(os.path.join(out, "params.tmp.npz"), **res)
os.replace(os.path.join(out, "params.tmp.npz"),
           os.path.join(out, "params.npz"))
res = {}
for case, spec in cases.items():
    cfg, mesh, ctx, params = setup(case, spec)
    pp = jax.device_put(params, jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), param_specs(params, ctx)))
    ecfg = eng.LMEngineConfig(**spec["engine"])
    step, state = build_engine(cfg, ctx, ecfg, pp)
    swap = cold = None
    if spec.get("swap"):
        swap, cold, _ = eng.make_swap_service(ecfg, cfg, ctx)
    n = [0]

    def snap(s):
        walk(s, f"{case}/t{n[0]}")
        if cold is not None:
            for k, v in cold.state_arrays().items():
                res[f"{case}/cold{n[0]}/{k}"] = np.array(v)
        n[0] += 1

    def inject(s, qids, p, c):
        return eng.lm_inject(s, jnp.asarray(qids), jnp.asarray(p),
                             gen_caps=jnp.asarray(c))

    dpr.run_engine(case, step, state, inject, snap, swap)
    res[f"{case}/steps"] = np.asarray(n[0])
    if cold is not None:
        res[f"{case}/evictions"] = np.asarray(cold.evictions)
        res[f"{case}/restores"] = np.asarray(cold.restores)
np.savez(os.path.join(out, "refs.npz"), **res)
print("refs OK")
'''


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's references, one subprocess with 8 forced host devices: every
    case's params first (``params.npz``), then the engines' states after
    every step (``refs.npz``)."""
    out = tmp_path_factory.mktemp("dp_engine_refs")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    with open(out / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(JAX_REFS), str(out),
             json.dumps(dpr.CASES), dpr.__file__],
            stdout=subprocess.DEVNULL, stderr=err, env=env)
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def _jax_failure(out) -> str:
    return "JAX's references failed:\n" + (
        out / "stderr.txt").read_text()[-3000:]


@pytest.fixture(scope="module")
def params_path(jax_run):
    proc, out = jax_run
    path = out / "params.npz"
    deadline = time.monotonic() + JAX_TIMEOUT
    while not path.exists():
        if proc.poll() is not None:
            pytest.fail(_jax_failure(out))
        assert time.monotonic() < deadline, "JAX's params timed out"
        time.sleep(0.2)
    return str(path)


@pytest.fixture(scope="module")
def ranks(params_path):
    """One launch a mesh: {case: [(data, model, outputs), ...]}."""
    out = {}
    for shape in dpr.MESHES:
        cases = [c for c, s in dpr.CASES.items() if s["mesh"] == shape]
        res = coll.launch(dpr.dp_rank, shape[0] * shape[1], backend="gloo",
                          args=(params_path, shape, cases),
                          timeout=RANK_TIMEOUT, num_threads=THREADS)
        for c in cases:
            out[c] = [(data, model, o[c]) for data, model, o in res]
    return out


@pytest.fixture(scope="module")
def refs(jax_run, ranks):
    proc, out = jax_run
    assert proc.wait(timeout=JAX_TIMEOUT) == 0, _jax_failure(out)
    return dict(np.load(out / "refs.npz"))


def _walk(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, f"{prefix}/{k}")
    else:
        yield prefix, node


def _want(refs, case, t):
    pre = f"{case}/t{t}"
    return {k[len(pre):]: v for k, v in refs.items()
            if k.startswith(pre + "/")}


def _block(want, got_shape, row_axis, data, model):
    """This rank's block of JAX's whole array: along ``row_axis`` its data
    coordinate's rows, along any other axis the rank holds less of its
    model coordinate's block (kv heads, recurrent-state heads)."""
    idx = []
    for ax, (w, g) in enumerate(zip(want.shape, got_shape)):
        if w == g:
            idx.append(slice(None))
            continue
        i = data if ax == row_axis else model
        idx.append(slice(i * g, (i + 1) * g))
    return want[tuple(idx)]


def _row_axis(path):
    """The slot-row axis of a decode-state leaf (None: not rows)."""
    if path == "/decode/pos":
        return 0
    if path.startswith("/decode/layers/"):
        return 1
    return None


CASES = list(dpr.CASES)
SWAP_CASES = [c for c in CASES if dpr.CASES[c].get("swap")]


@pytest.mark.parametrize("case", CASES)
def test_engine_integers_match_jax_on_every_rank(refs, ranks, case):
    """Every request completes in JAX's steps, and after every step every
    integer of each rank's engine state equals JAX's: the rings,
    scheduler, slots and responses whole, the decode state's integer
    rows the rank's rows of JAX's (all of them where the data ranks do
    not divide the slots), the page pool's allocator whole."""
    n = int(refs[case + "/steps"])
    for data, model, out in ranks[case]:
        assert len(out["steps"]) == n, (case, data, model)
        assert int(out["steps"][-1]["completed"]) == len(
            dpr.requests(case, 128)[0])
        for t, st in enumerate(out["steps"]):
            want = _want(refs, case, t)
            got = dict(_walk(st))
            assert got.keys() == want.keys(), case
            for path, g in got.items():
                if g.dtype.kind == "f":
                    continue
                w = want[path]
                ax = _row_axis(path)
                if ax is not None:
                    w = _block(w, g.shape, ax, data, model)
                assert g.dtype == w.dtype, path
                np.testing.assert_array_equal(
                    g, w, err_msg=f"{case} step {t} {path} {data, model}")


@pytest.mark.parametrize("case", [c for c in CASES
                                  if not dpr.CASES[c]["engine"].get("paged")])
def test_dense_decode_rows_match_jax_on_every_rank(refs, ranks, case):
    """The dense engine's decode state after every step: each rank's
    float leaves (rings, recurrent states, token shifts) its block of
    JAX's (its rows, or all where the slots are replicated; its kv and
    state heads) within TOL."""
    shape = dpr.CASES[case]["mesh"]
    slots = dpr.CASES[case]["engine"]["slots"]
    for data, model, out in ranks[case]:
        for t, st in enumerate(out["steps"]):
            want = _want(refs, case, t)
            for path, g in _walk(st):
                if g.dtype.kind != "f":
                    continue
                assert path.startswith("/decode/layers/"), path
                w = _block(want[path], g.shape, 1, data, model)
                rows = slots // shape[0] if slots % shape[0] == 0 else slots
                assert g.shape[1] == rows, (case, path, g.shape)
                np.testing.assert_allclose(
                    g, w, rtol=TOL, atol=TOL,
                    err_msg=f"{case} step {t} {path} {data, model}")


def _live_tokens(st, rows):
    """(slot, page, offset) of every token the HOT slots in ``rows``
    hold."""
    ps = st["decode"]["k_pages"].shape[2]
    out = []
    for slot in rows:
        if st["decode"]["residency"][slot] != 0:
            continue
        for tok in range(int(st["decode"]["lengths"][slot])):
            page = int(st["decode"]["page_table"][slot, tok // ps])
            out.append((slot, page, tok % ps))
    return out


def _own_rows(case, data):
    shape, slots = dpr.CASES[case]["mesh"], dpr.CASES[case]["engine"]["slots"]
    if slots % shape[0]:
        return range(slots)
    n = slots // shape[0]
    return range(data * n, (data + 1) * n)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if dpr.CASES[c]["engine"].get("paged")])
def test_paged_pool_live_tokens_match_jax_on_every_rank(refs, ranks, case):
    """After every step, each live token of the rank's slots (its rows of
    the page table, up to each slot's length) is JAX's token on the
    rank's kv heads within TOL; over the run at least one is checked on
    every rank."""
    tp = dpr.CASES[case]["mesh"][1]
    for data, model, out in ranks[case]:
        seen = 0
        for t, st in enumerate(out["steps"]):
            want = _want(refs, case, t)
            live = _live_tokens(st, _own_rows(case, data))
            seen += len(live)
            for path in POOL:
                g = dict(_walk(st))[path]
                w = want[path]
                kv = w.shape[3] // tp
                assert g.shape == w.shape[:3] + (kv,) + w.shape[4:]
                for slot, page, off in live:
                    np.testing.assert_allclose(
                        g[:, page, off],
                        w[:, page, off, model * kv:(model + 1) * kv],
                        rtol=TOL, atol=TOL,
                        err_msg=f"{case} step {t} {path} slot {slot}")
        assert seen, (case, data, model)


@pytest.mark.parametrize("case", SWAP_CASES)
def test_swap_service_evicts_restores_and_matches_jax(refs, ranks, case):
    """The swap service before every step: JAX's evictions and restores
    (at least one each) on every rank; after every step the host tier's
    allocator (its page owners and ranks, free list, eviction order,
    counters) equals JAX's, and every parked page of the rank's slots is
    JAX's slab on its kv heads within TOL (some rank's, at some step)."""
    ev, rs = int(refs[case + "/evictions"]), int(refs[case + "/restores"])
    assert ev >= 1 and rs >= 1, (ev, rs)
    tp = dpr.CASES[case]["mesh"][1]
    parked = 0
    for data, model, out in ranks[case]:
        assert (out["evictions"], out["restores"]) == (ev, rs)
        assert out["parks"] == list(_own_rows(case, data))
        for t, cold in enumerate(out["cold"]):
            for k, g in cold.items():
                w = refs[f"{case}/cold{t}/{k}"]
                if k not in COLD_SLABS:
                    np.testing.assert_array_equal(
                        g, w, err_msg=f"{case} step {t} cold {k}")
                    continue
                kv = w.shape[3] // tp
                for page, slot in enumerate(cold["slot_of_page"]):
                    if slot in out["parks"]:
                        parked += 1
                        np.testing.assert_allclose(
                            g[:, page],
                            w[:, page, :, model * kv:(model + 1) * kv],
                            rtol=TOL, atol=TOL,
                            err_msg=f"{case} step {t} cold {k} page {page}")
    assert parked, case


@pytest.mark.parametrize("case", SWAP_CASES)
def test_rank_flush_restores_its_state_bit_for_bit(ranks, case):
    """Each rank flushes its paged state and cold tier through
    ``fault.DurabilityManager`` after every step (a full snapshot, then
    deltas) and recovers them, with a fresh tier of its slots, bit for
    bit."""
    for data, model, out in ranks[case]:
        assert out["flush"]["bit_equal"], (case, data, model)
        assert out["flush"]["deltas"] >= 1, out["flush"]


@pytest.mark.parametrize("pages", dpr.BUDGET_PAGES)
def test_swap_service_budget_decides_alike_on_every_rank(pages):
    """Under a host-memory budget each data rank charges only the pages it
    parks, yet every rank takes the eviction only where the victim's
    rank has the headroom: after every step each rank's integers equal
    the one process's under the same budget (a budget too small for any
    victim refuses every eviction on every rank; one of 8 pages takes
    one)."""
    want, ev, rs = dpr.budget_run(None, pages)
    assert (ev, rs) == ((0, 0) if pages == dpr.BUDGET_PAGES[0] else (1, 1))
    res = coll.launch(dpr.budget_rank, 2, backend="gloo", args=(pages,),
                      timeout=RANK_TIMEOUT, num_threads=THREADS)
    for rank, (got, r_ev, r_rs) in enumerate(res):
        assert (r_ev, r_rs) == (ev, rs), rank
        assert len(got) == len(want), rank
        for t, (g, w) in enumerate(zip(got, want)):
            assert g.keys() == w.keys()
            for path in w:
                np.testing.assert_array_equal(
                    g[path], w[path], err_msg=f"rank {rank} step {t} {path}")


def test_engine_over_data_ranks_refuses_an_ep_batch_it_cannot_split():
    """The EP shard_map admission runs in JAX's data blocks, so a padded
    batch the data ranks do not divide is refused."""
    from repro_torch.core import engine as eng
    from repro_torch.parallel.sharding import Mesh

    cfg = dpr.case_config("moe_ep_2x2")
    ctx = dpr.case_context("moe_ep_2x2", Mesh((2, 2), ("data", "model")))
    assert eng.admission_blocks(4, cfg, ctx) == [slice(0, 2), slice(2, 4)]
    with pytest.raises(ValueError, match="data ranks"):
        eng.admission_blocks(3, cfg, ctx)
    gspmd = dpr.case_context("moe_paged_2x2", Mesh((2, 2), ("data", "model")))
    assert eng.admission_blocks(3, cfg, gspmd) == [slice(0, 3)]
