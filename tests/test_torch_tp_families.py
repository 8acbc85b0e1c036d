"""Megatron tensor parallelism of the vlm, audio, ssm and hybrid families'
serving across gloo ranks on the CPU, held against the JAX package's
GSPMD steps.

JAX's references run once for the module in one subprocess with 8 forced
host devices on ``AxisType.Auto`` meshes (as ``test_torch_tp.py``'s):
each case's params from JAX's ``init_params`` at the mesh's padded head
plan, placed by ``param_specs``; JAX's jitted ``forward``, ``loss_fn``,
``prefill`` and ``decode_step`` (and, for the vlm, ssm and hybrid, the
dense LM engine of ``launch.serve.build_engine``) run on them. The
port's ranks (``torch_tp_families_ranks``; one launch a mesh) take
their blocks of the same params and the same seeded inputs (the vlm's
media, the audio's codebook frames) while JAX computes.

What a rank holds: the vlm's heads as the dense family's (M-RoPE
positions and the media rows whole); the audio's codebook embedding and
heads split on vocab per codebook; the RWKV6 time mix's heads (its
replicated per-head vectors sliced) and the channel mix's column blocks;
the hybrid's padded heads (5 q at tp 2: 6, one masked) and the whole
replicated Mamba branch, whose state is split over the model axis where
its heads divide it (``decode_state_specs``).

Tolerances: f32 logits and decode states within 2e-5 (rtol and atol:
the model-axis sums add in other orders than XLA's); the loss value
within 1e-5 relative; every integer of the engine state equal; the
model ranks' logits equal bit for bit."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import torch_tp_families_ranks as tfr
from repro_torch.parallel import collectives as coll

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANK_TIMEOUT = 120  # s, each collective's bound (and the launch's, + 60)
THREADS = 1
TOL = 2e-5
JAX_TIMEOUT = 600  # s

JAX_REFS = r'''
import json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, AxisType

sys.path.insert(0, os.path.dirname(sys.argv[3]))
import torch_tp_families_ranks as tfr  # the case table and inputs
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
        res[prefix] = np.array(node)


def setup(spec):
    cfg = reduced(get_config(spec["arch"])).replace(
        dtype="float32", **spec.get("cfg", {}))
    mesh = mesh_of(tuple(spec["mesh"]))
    ctx = make_context(mesh, cfg)
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
    toks, labels, media, fed = tfr.inputs(cfg)
    toks, labels = jnp.asarray(toks), jnp.asarray(labels)
    media = None if media is None else jnp.asarray(media)
    if "fwd" in spec["parts"]:
        batch = {"tokens": toks, "labels": labels}
        if media is not None:
            batch["media"] = media
        (logits, _), (loss, _) = jax.jit(lambda p, t, b, m: (
            M.forward(p, t, cfg, ctx, media=m, chunk=tfr.CHUNK),
            M.loss_fn(p, b, cfg, ctx, chunk=tfr.CHUNK)))(pp, toks, batch,
                                                         media)
        res[case + "/fwd"] = np.asarray(logits)
        res[case + "/loss"] = np.asarray(loss)
    if "decode" in spec["parts"]:
        st = M.make_decode_state(cfg, ctx, tfr.BATCH, tfr.CACHE_LEN)
        st, last = jax.jit(lambda p, t, s, m: M.prefill(
            p, t, s, cfg, ctx, media=m, chunk=tfr.CHUNK))(pp, toks, st,
                                                          media)
        dec = jax.jit(lambda p, t, s: M.decode_step(p, t, s, cfg, ctx))
        logits = [np.asarray(last)]
        for tok in fed:
            st, lg = dec(pp, jnp.asarray(tok), st)
            logits.append(np.asarray(lg))
        res[case + "/decode_logits"] = np.stack(logits)
        walk(st, case + "/state")
    if "engine" in spec["parts"]:
        ecfg = eng.LMEngineConfig(**tpr.ENGINE)
        step, state = build_engine(cfg, ctx, ecfg, pp)
        prompts, caps = tpr.engine_requests(cfg.vocab_size)
        q = ecfg.num_queues
        for lo in range(0, len(prompts), q):
            n = len(prompts[lo:lo + q])
            state = eng.lm_inject(state, jnp.arange(n, dtype=jnp.int32),
                                  jnp.asarray(prompts[lo:lo + q]),
                                  gen_caps=jnp.asarray(caps[lo:lo + q]))
        for _ in range(tpr.ENGINE_REQUESTS * ecfg.gen_len):
            state = step(state)
            if int(state.completed) == tpr.ENGINE_REQUESTS:
                break
        walk(state, case + "/engine")
np.savez(os.path.join(out, "refs.npz"), **res)
print("refs OK")
'''


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's references, one subprocess with 8 forced host devices: every
    case's params first (``params.npz``), then the steps' results."""
    out = tmp_path_factory.mktemp("tp_families_refs")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    with open(out / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(JAX_REFS), str(out),
             json.dumps(tfr.CASES), tfr.__file__],
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
    """One launch a mesh: {case: [(model, outputs), ...]}."""
    out = {}
    for shape in tfr.MESHES:
        cases = [c for c, s in tfr.CASES.items() if s["mesh"] == shape]
        res = coll.launch(tfr.families_rank, shape[0] * shape[1],
                          backend="gloo", args=(params_path, shape, cases),
                          timeout=RANK_TIMEOUT, num_threads=THREADS)
        for c in cases:
            out[c] = [(model, o[c]) for model, o in res]
    return out


@pytest.fixture(scope="module")
def refs(jax_run, ranks):
    proc, out = jax_run
    assert proc.wait(timeout=JAX_TIMEOUT) == 0, _jax_failure(out)
    return dict(np.load(out / "refs.npz"))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


def _walk(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _walk(v, f"{prefix}/{k}")
    else:
        yield prefix, node


def _heads_block(want, got_shape, model):
    """This model rank's block of JAX's whole array along every axis the
    rank holds less of (kv heads, recurrent-state heads)."""
    idx = tuple(slice(None) if w == g else slice(model * g, (model + 1) * g)
                for w, g in zip(want.shape, got_shape))
    return want[idx]


def _parts(part):
    return [c for c, s in tfr.CASES.items() if part in s["parts"]]


@pytest.mark.parametrize("case", _parts("fwd"))
def test_forward_and_loss_match_jax_gspmd(refs, ranks, case):
    """Each rank's forward logits (whole vocab: (B, S, V), or (B, S, K, V)
    for the codebooks) are JAX's within TOL and the ranks' equal bit for
    bit; the loss value is JAX's within 1e-5 relative on every rank."""
    outs = ranks[case]
    for model, out in outs:
        _close(out["fwd"], refs[case + "/fwd"], f"{case} fwd rank {model}")
        np.testing.assert_allclose(out["loss"], refs[case + "/loss"],
                                   rtol=1e-5)
        np.testing.assert_array_equal(out["fwd"], outs[0][1]["fwd"])


@pytest.mark.parametrize("case", _parts("decode"))
def test_prefill_and_decode_match_jax_gspmd(refs, ranks, case):
    """prefill, then DECODE_STEPS decode steps fed the same seeded tokens:
    every step's logits within TOL of JAX's and equal across the ranks;
    the final decode state each rank's block of JAX's (its kv heads, its
    recurrent-state heads where the spec splits them) within TOL,
    positions equal."""
    outs = ranks[case]
    pre = case + "/state"
    want = {k[len(pre):]: v for k, v in refs.items()
            if k.startswith(pre + "/")}
    for model, out in outs:
        _close(out["decode_logits"], refs[case + "/decode_logits"],
               f"{case} decode rank {model}")
        np.testing.assert_array_equal(out["decode_logits"],
                                      outs[0][1]["decode_logits"])
        got = dict(_walk(out["state"]))
        assert got.keys() == want.keys()
        for path, g in got.items():
            w = _heads_block(want[path], g.shape, model)
            if g.dtype.kind == "f":
                _close(g, w, f"{case} {path} rank {model}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("case", _parts("engine"))
def test_dense_engine_matches_jax_engine_on_every_rank(refs, ranks, case):
    """The dense LM engine on (1, 2): every integer of each rank's engine
    state is JAX's (responses, rings, slots, positions), the decode
    state's floats its block of JAX's within TOL."""
    pre = case + "/engine"
    want = {k[len(pre):]: v for k, v in refs.items()
            if k.startswith(pre + "/")}
    for model, out in ranks[case]:
        got = dict(_walk(out["engine"]))
        assert int(got["/completed"]) == 6
        assert got.keys() == want.keys()
        for path, g in got.items():
            w = _heads_block(want[path], g.shape, model)
            if g.dtype.kind == "f":
                _close(g, w, f"{case} {path} rank {model}")
            else:
                assert g.dtype == w.dtype, path
                np.testing.assert_array_equal(g, w, err_msg=path)


def test_hybrid_plan_pads_heads_and_splits_the_mamba_state():
    """The hybrid case at tp 2: 5 q heads padded to 6 (3 a rank), the kv
    head replicated, and the Mamba state's 2 heads split one a rank; at
    the reduced din (1 state head) the state is whole on every rank."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import model, transformer as tf
    from repro_torch.parallel.sharding import Mesh

    cfg = tfr.case_config("hybrid_1x2")
    ctx = lmesh.make_context(Mesh((1, 2), ("data", "model")), cfg)
    plan = tf.plan_for(cfg, ctx)
    assert (plan.hp, plan.kvp, plan.repl) == (6, 1, 2)
    assert tf.mamba_state_split(cfg, ctx)
    st = model.make_decode_state(cfg, ctx, 2, 8, "cpu")
    assert st.layers["s"].shape[2] == 1
    spec = model.decode_state_specs(cfg, ctx, 2).layers["s"]
    assert spec[2] == "model"
    whole = cfg.replace(ssm_expand=2)
    assert not tf.mamba_state_split(whole, ctx)
    assert model.decode_state_specs(whole, ctx, 2).layers["s"][2] is None
    assert model.make_decode_state(whole, ctx, 2, 8,
                                   "cpu").layers["s"].shape[2] == 1


def test_training_refuses_the_serving_only_families_under_tp():
    """``stack_train`` (the forward under a gradient, ``loss_fn``'s
    backward) refuses the vlm, audio, ssm and hybrid families at tp > 1,
    naming the training item; under no gradient their forward is the
    serving stack."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    from repro_torch.parallel.sharding import Mesh, ParallelContext

    ctx = ParallelContext(mesh=Mesh((1, 2), ("data", "model")))
    for arch in (tfr.VLM, tfr.AUDIO, tfr.SSM, tfr.HYBRID):
        cfg = configs.reduced(configs.get_config(arch))
        tf.check_tp(cfg, ctx)  # serving runs
        with pytest.raises(NotImplementedError, match="item 3b"):
            tf.stack_train({}, torch.zeros((1, 2, cfg.d_model)), cfg,
                           tf.plan_for(cfg, ctx), ctx, None)
