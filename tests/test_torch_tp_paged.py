"""The port's paged LM engine under Megatron tensor parallelism across gloo
ranks on the CPU, held against the JAX package's paged engine under
GSPMD.

JAX's references run once for the module in one subprocess with 8 forced
host devices on ``AxisType.Auto`` meshes (as in ``test_torch_tp.py``):
each case's params from JAX's ``init_params`` at the mesh's padded head
plan, placed by ``param_specs``, then ``launch.serve.build_engine(...,
paged=True)`` with the plain page walk over ``torch_tp_ranks``'
requests until all complete. The port's ranks (``torch_tp_paged_ranks``;
one launch a mesh) run the same engine on their blocks while JAX
computes, from the params it writes first.

Each rank's pool holds its kv heads (``plan.kv_phys / tp``: on (1, 4)
one replica of the reduced config's one kv head); its decode walks its q
heads over them and its admission prefills them; the logits come back
whole, so every rank takes the same decisions. Checks: every integer of
each rank's engine state equals JAX's (rings, slots, page table, free
list, lengths, residency, responses); the rank's pages within 2e-5 of
JAX's pages of its kv heads; the ranks bit-equal apart from their
pages."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import torch_tp_paged_ranks as tpp
import torch_tp_ranks as tpr
from repro_torch.parallel import collectives as coll

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANK_TIMEOUT = 60  # s, each collective's bound (and the launch's, + 60)
THREADS = 1
TOL = 2e-5
JAX_TIMEOUT = 300  # s
POOL = ("/decode/k_pages", "/decode/v_pages")

JAX_REFS = r'''
import json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, AxisType

sys.path.insert(0, os.path.dirname(sys.argv[3]))
import torch_tp_paged_ranks as tpp  # the case table
import torch_tp_ranks as tpr
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
        res[prefix] = np.asarray(node)


def setup(spec):
    cfg = reduced(get_config(spec["arch"])).replace(
        dtype="float32", **spec.get("cfg", {}))
    mesh = mesh_of(tuple(spec["mesh"]))
    ctx = make_context(mesh, cfg)._replace(
        ep_shardmap=spec.get("ep_shardmap", False))
    return cfg, mesh, ctx, M.init_params(jax.random.key(0), cfg, ctx)


for case, spec in cases.items():
    flat(setup(spec)[3], case + "/params/")
np.savez(os.path.join(out, "params.tmp.npz"), **res)
os.replace(os.path.join(out, "params.tmp.npz"),
           os.path.join(out, "params.npz"))
res = {}
for case, spec in cases.items():
    cfg, mesh, ctx, params = setup(spec)
    pp = jax.device_put(params, jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), param_specs(params, ctx)))
    ecfg = eng.LMEngineConfig(**tpp.ENGINE)
    step, state = build_engine(cfg, ctx, ecfg, pp)
    prompts, caps = tpr.engine_requests(cfg.vocab_size)

    def inject(s, qids, p, c):
        return eng.lm_inject(s, jnp.asarray(qids), jnp.asarray(p),
                             gen_caps=jnp.asarray(c))

    state = tpp.run_engine(step, state, inject, prompts, caps,
                           ecfg.num_queues, tpr.ENGINE_REQUESTS)
    walk(state, case)
np.savez(os.path.join(out, "refs.npz"), **res)
print("refs OK")
'''


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's references, one subprocess with 8 forced host devices: every
    case's params first (``params.npz``), then the engines' final states
    (``refs.npz``)."""
    out = tmp_path_factory.mktemp("tp_paged_refs")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    with open(out / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(JAX_REFS), str(out),
             json.dumps(tpp.CASES), tpp.__file__],
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
    """One launch a mesh: {case: [(model rank, final state), ...]}."""
    out = {}
    for shape in tpp.MESHES:
        cases = [c for c, s in tpp.CASES.items() if s["mesh"] == shape]
        res = coll.launch(tpp.paged_rank, shape[0] * shape[1],
                          backend="gloo", args=(params_path, shape, cases),
                          timeout=RANK_TIMEOUT, num_threads=THREADS)
        for c in cases:
            out[c] = [(model, states[c]) for model, states in res]
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


CASES = list(tpp.CASES)


@pytest.mark.parametrize("case", CASES)
def test_paged_engine_state_matches_jax_on_every_rank(refs, ranks, case):
    """Every request completes, and every integer of each rank's engine
    state (responses, rings, slots, page table, free list, lengths,
    residency) equals JAX's paged engine's under GSPMD."""
    want = {k[len(case):]: v for k, v in refs.items()
            if k.startswith(case + "/")}
    for model, st in ranks[case]:
        assert int(st["completed"]) == tpr.ENGINE_REQUESTS, (case, model)
        got = dict(_walk(st))
        assert got.keys() == want.keys(), case
        for path, g in got.items():
            if path in POOL:
                continue
            assert g.dtype == want[path].dtype, path
            np.testing.assert_array_equal(g, want[path],
                                          err_msg=f"{case} {path} {model}")


@pytest.mark.parametrize("case", CASES)
def test_rank_pool_holds_its_kv_heads_of_jax_pool(refs, ranks, case):
    """Each rank's page pool (L, NP + 1, PS, KVH / tp, hd) is its kv heads
    of JAX's pool within TOL: on (1, 4) the reduced config's one kv head,
    replicated, is one head a rank."""
    tp = tpp.CASES[case]["mesh"][1]
    for model, st in ranks[case]:
        got = dict(_walk(st))
        for path in POOL:
            want = refs[case + path]
            kv = want.shape[3] // tp
            assert got[path].shape == want.shape[:3] + (kv,) + want.shape[4:]
            np.testing.assert_allclose(
                got[path], want[:, :, :, model * kv:(model + 1) * kv],
                rtol=TOL, atol=TOL, err_msg=f"{case} {path} rank {model}")


@pytest.mark.parametrize("case", CASES)
def test_paged_ranks_are_bit_equal_apart_from_their_pools(ranks, case):
    """The ranks' engine states are equal bit for bit outside the pages
    (each holds its own kv heads there): the logits are whole on every
    rank, so every decision is the same."""
    outs = [dict(_walk(st)) for _, st in ranks[case]]
    for other in outs[1:]:
        for path, a in outs[0].items():
            if path not in POOL:
                np.testing.assert_array_equal(a, other[path], err_msg=path)


@pytest.mark.parametrize("case", CASES)
def test_paged_kv_config_sizes_the_rank_pool(case):
    """``make_paged_kv_config`` (and the engine's ``lm_paged_kv_config``)
    give a rank ``plan.kv_phys / tp`` kv heads."""
    from repro_torch.core import engine as eng
    from repro_torch.models import transformer as tf
    from repro_torch.parallel.sharding import Mesh

    shape = tpp.CASES[case]["mesh"]
    cfg = tpp.case_config(case)
    ctx = tpp.case_context(case, Mesh(shape, ("data", "model")))
    plan = tf.plan_for(cfg, ctx)
    pcfg = eng.lm_paged_kv_config(eng.LMEngineConfig(**tpp.ENGINE), cfg,
                                  ctx)
    assert pcfg.kv_heads == plan.kv_phys // shape[1] >= 1
    if shape == (1, 4):
        assert (plan.kvp, plan.repl, pcfg.kv_heads) == (1, 4, 1)
