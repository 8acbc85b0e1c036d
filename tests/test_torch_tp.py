"""The port's Megatron tensor parallelism of LM serving across gloo ranks
on the CPU, held against the JAX package's GSPMD steps.

JAX's references run once for the module in one subprocess with 8 forced
host devices, on meshes built with ``AxisType.Auto`` axes (under jax
0.9, ``jax.make_mesh``'s default Explicit axes refuse the sharded
embedding gather): each case's params come from JAX's ``init_params`` at
the mesh's padded head plan, placed by ``param_specs``, and JAX's jitted
``forward``, ``loss_fn``, ``prefill`` and ``decode_step`` (and, on (1,
2), its dense LM engine) run on them. The port's ranks
(``torch_tp_ranks``; one launch a mesh, every case of that mesh in it)
take their blocks of the same params (``interop.lm_params_from_numpy``,
then ``sharding.param_blocks``) and their rows of the same tokens.

Decode steps are teacher-forced on both sides by the same seeded tokens
(``torch_tp_ranks.fed_tokens``), so the ranks need only JAX's params,
which the subprocess writes first: the launches run while JAX computes.

Tolerances: f32 logits and caches within 2e-5 (rtol and atol: the
row-split products and the vocab-parallel sums add in other orders than
XLA's, on top of the 1e-5 the one-device comparisons allow); the loss
value within 1e-5 relative; greedy tokens, positions and every integer
of the engine state equal; ranks that hold the same rows equal bit for
bit."""
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

import torch_tp_ranks as tpr
from repro_torch import configs
from repro_torch.parallel import collectives as coll

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANK_TIMEOUT = 60  # s, each collective's bound (and the launch's, + 60)
THREADS = 1
TOL = 2e-5

JAX_REFS = r'''
import json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, AxisType

sys.path.insert(0, os.path.dirname(sys.argv[3]))
import torch_tp_ranks as tpr  # the case table (numpy-only helpers)
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


def setup(spec):
    cfg = reduced(get_config(spec["arch"])).replace(
        dtype="float32", **spec.get("cfg", {}))
    mesh = mesh_of(tuple(spec["mesh"]))
    ctx = make_context(mesh, cfg, sp=spec.get("sp", False))._replace(
        ep_shardmap=spec.get("ep_shardmap", False))
    return cfg, mesh, ctx, M.init_params(jax.random.key(0), cfg, ctx)


# first every case's params (the ranks start from them), then the steps
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
    toks, labels = (jnp.asarray(a) for a in tpr.inputs(cfg.vocab_size))
    if "fwd" in spec["parts"]:
        (logits, aux), (loss, m) = jax.jit(lambda p, t, l: (
            M.forward(p, t, cfg, ctx, chunk=tpr.CHUNK),
            M.loss_fn(p, {"tokens": t, "labels": l}, cfg, ctx,
                      chunk=tpr.CHUNK)))(pp, toks, labels)
        res[case + "/fwd"] = np.asarray(logits)
        res[case + "/aux"] = np.asarray(aux)
        res[case + "/loss"] = np.asarray(loss)
        res[case + "/ce"] = np.asarray(m["ce"])
    if "decode" in spec["parts"]:
        st = M.make_decode_state(cfg, ctx, tpr.BATCH, tpr.CACHE_LEN)
        st, last = jax.jit(lambda p, t, s: M.prefill(
            p, t, s, cfg, ctx, chunk=tpr.CHUNK))(pp, toks, st)
        dec = jax.jit(lambda p, t, s: M.decode_step(p, t, s, cfg, ctx))
        logits = [np.asarray(last)]
        for tok in tpr.fed_tokens(cfg.vocab_size):
            st, lg = dec(pp, jnp.asarray(tok), st)
            logits.append(np.asarray(lg))
        res[case + "/decode_logits"] = np.stack(logits)
        res[case + "/k"] = np.asarray(st.layers["k"])
        res[case + "/v"] = np.asarray(st.layers["v"])
        res[case + "/pos"] = np.asarray(st.pos)

# the dense engine on (1, 2), the dense_1x2 params
cfg = reduced(get_config(tpr.DENSE)).replace(dtype="float32")
mesh = mesh_of((1, 2))
ctx = make_context(mesh, cfg)
params = M.init_params(jax.random.key(0), cfg, ctx)
pp = jax.device_put(params, jax.tree_util.tree_map(
    lambda s: NamedSharding(mesh, s), param_specs(params, ctx)))
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


def walk(node, prefix):
    if hasattr(node, "_fields"):
        for f in node._fields:
            walk(getattr(node, f), f"{prefix}/{f}")
    elif isinstance(node, dict):
        for k, v in node.items():
            walk(v, f"{prefix}/{k}")
    else:
        res["engine" + prefix] = np.asarray(node)


walk(state, "")
np.savez(os.path.join(out, "refs.npz"), **res)
print("refs OK")
'''


JAX_TIMEOUT = 300  # s


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's references, one subprocess with 8 forced host devices: it
    writes every case's params first (``params.npz``), then the steps'
    results (``refs.npz``), so the ranks run while JAX computes."""
    out = tmp_path_factory.mktemp("tp_refs")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    # stderr to a file: a pipe left unread while the ranks run could fill
    with open(out / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(JAX_REFS), str(out),
             json.dumps(tpr.CASES), tpr.__file__],
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
def refs(jax_run, ranks):
    proc, out = jax_run
    assert proc.wait(timeout=JAX_TIMEOUT) == 0, _jax_failure(out)
    return dict(np.load(out / "refs.npz"))


@pytest.fixture(scope="module")
def ranks(params_path):
    """One launch a mesh: {mesh shape: [(data, model, outputs), ...]}."""
    out = {}
    for shape in tpr.MESHES:
        cases = [c for c, s in tpr.CASES.items() if s["mesh"] == shape]
        out[shape] = coll.launch(
            tpr.tp_rank, shape[0] * shape[1], backend="gloo",
            args=(params_path, shape, cases), timeout=RANK_TIMEOUT,
            num_threads=THREADS)
    return out


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _rows(x, data, dp):
    b = x.shape[0] // dp
    return x[data * b:(data + 1) * b]


def _each_rank(ranks, case):
    shape = tpr.CASES[case]["mesh"]
    for data, model, out in ranks[shape]:
        yield data, model, shape, out[case]


def _same_across_model_ranks(ranks, case, key):
    """Ranks holding the same rows give the same bits."""
    seen = {}
    for data, _, _, out in _each_rank(ranks, case):
        if data in seen:
            np.testing.assert_array_equal(out[key], seen[data],
                                          err_msg=f"{case} {key}")
        seen[data] = out[key]


FWD = [c for c, s in tpr.CASES.items() if "fwd" in s["parts"]]
DECODE = [c for c, s in tpr.CASES.items() if "decode" in s["parts"]]


@pytest.mark.parametrize("case", FWD)
def test_forward_matches_jax_gspmd(refs, ranks, case):
    """Each rank's forward logits are JAX's GSPMD logits of its rows
    (whole vocab, gathered), within TOL; equal across its model ranks."""
    for data, _, shape, out in _each_rank(ranks, case):
        _close(out["fwd"], _rows(refs[case + "/fwd"], data, shape[0]),
               f"{case} fwd rank data {data}")
    _same_across_model_ranks(ranks, case, "fwd")


@pytest.mark.parametrize("case", FWD)
def test_loss_value_matches_jax_gspmd(refs, ranks, case):
    """The vocab-parallel loss: the data ranks' means (each over its rows)
    average to JAX's loss, within 1e-5 relative; the aux loss (MoE) is
    JAX's global one on every rank."""
    by_data = {}
    for data, _, shape, out in _each_rank(ranks, case):
        by_data.setdefault(data, []).append(out)
        np.testing.assert_allclose(out["aux"], refs[case + "/aux"],
                                   rtol=1e-5, atol=1e-7)
    loss = np.mean([v[0]["loss"] for v in by_data.values()])
    np.testing.assert_allclose(loss, refs[case + "/loss"], rtol=1e-5)
    for outs in by_data.values():
        assert len({o["loss"] for o in outs}) == 1, case


@pytest.mark.parametrize("case", DECODE)
def test_prefill_and_decode_match_jax_gspmd(refs, ranks, case):
    """prefill, then DECODE_STEPS decode steps, both sides fed the same
    seeded tokens: every step's logits within TOL of JAX's, each step's
    greedy token JAX's, the final rings' k/v this rank's block (its rows,
    its kv heads) of JAX's, positions equal; equal across model ranks."""
    want = refs[case + "/decode_logits"]
    for data, model, shape, out in _each_rank(ranks, case):
        dp, tp = shape
        _close(out["decode_logits"],
               np.stack([_rows(w, data, dp) for w in want]),
               f"{case} decode rank {data, model}")
        np.testing.assert_array_equal(out["greedy"],
                                      np.stack([_rows(w, data, dp).argmax(-1)
                                                for w in want]))
        for f in ("k", "v"):
            full = refs[f"{case}/{f}"]  # (L, B, Sc, kv_phys, hd)
            kv = full.shape[3] // tp
            blk = _rows(full.swapaxes(0, 1), data, dp).swapaxes(0, 1)
            _close(out[f], blk[:, :, :, model * kv:(model + 1) * kv],
                   f"{case} {f} rank {data, model}")
        np.testing.assert_array_equal(out["pos"],
                                      _rows(refs[case + "/pos"], data, dp))
    for key in ("decode_logits", "k", "v"):
        _same_across_model_ranks(ranks, case, key)


def test_one_four_mesh_replicates_the_kv_head():
    """(1, 4) at the reduced config's 4 q / 1 kv heads: the plan pads kv
    to 1 and replicates it 4 times, one replica and one q head a rank."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import transformer as tf
    from repro_torch.parallel.sharding import Mesh

    cfg = tpr.case_config("dense_1x4")
    ctx = lmesh.make_context(Mesh((1, 4), ("data", "model")), cfg)
    plan = tf.plan_for(cfg, ctx)
    assert (plan.hp, plan.kvp, plan.repl, plan.kv_phys) == (4, 1, 4, 4)


def test_engine_matches_jax_engine_on_every_rank(refs, ranks):
    """The dense LM engine on (1, 2): both ranks' engine states are JAX's
    engine's under GSPMD — responses, rings, slots, every integer equal;
    the decode rings each rank's kv heads of JAX's within TOL — and the
    two ranks' states equal bit for bit."""
    outs = [out["engine"] for _, _, out in ranks[(1, 2)]]

    def walk(node, prefix=""):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, f"{prefix}/{k}")
        else:
            yield prefix, node

    for model, st in enumerate(outs):
        assert int(st["completed"]) == tpr.ENGINE_REQUESTS
        for path, got in walk(st):
            want = refs["engine" + path]
            if path.startswith("/decode/layers/") and path[-2:] in ("/k",
                                                                    "/v"):
                kv = want.shape[3] // 2
                _close(got, want[:, :, :, model * kv:(model + 1) * kv],
                       path)
            else:
                assert got.dtype == want.dtype, path
                np.testing.assert_array_equal(got, want, err_msg=path)
    for (path, a), (_, b) in zip(walk(outs[0]), walk(outs[1])):
        if not path.endswith(("/k", "/v")):
            np.testing.assert_array_equal(a, b, err_msg=path)


def test_tensor_parallel_refuses_what_it_does_not_run(monkeypatch):
    """tp > 1 refuses training of the families it serves only (the vlm,
    audio, ssm and hybrid: ``stack_train``, naming the training item)
    and a sequence the model axis does not divide under sp; the rank's
    page pool holds its kv heads; gradients flow (the model-axis
    collectives have a backward, held against one process in
    ``test_torch_tp_train.py``)."""
    from repro_torch.models import model, transformer as tf
    from repro_torch.parallel.sharding import Mesh, ParallelContext

    ctx = ParallelContext(mesh=Mesh((1, 2), ("data", "model")))
    for arch in ("rwkv6-1.6b", "hymba-1.5b", "qwen2-vl-7b",
                 "musicgen-large"):
        cfg = configs.reduced(configs.get_config(arch))
        with pytest.raises(NotImplementedError, match="tensor parallelism"):
            tf.check_tp_train(cfg, ctx)
    cfg = tpr.case_config("dense_1x2")
    pcfg = model.make_paged_kv_config(cfg, ctx, num_pages=4, page_size=2,
                                      max_pages_per_seq=2)
    assert pcfg.kv_heads == tf.plan_for(cfg, ctx).kv_phys // 2
    with pytest.raises(ValueError, match="sequence parallelism"):
        tf._seq_parallel(ctx._replace(sp=True), torch.zeros((1, 3, 4)))
    # model_psum at tp 2 now returns a gradient: the transport stands in
    # for two ranks holding equal partials (the sum doubles them), and the
    # backward is the identity
    x = torch.ones(2, requires_grad=True)
    monkeypatch.setattr(coll, "_all_reduce", lambda t, mesh, axis: 2 * t)
    y = coll.model_psum(x, ctx)
    assert torch.equal(y, torch.full((2,), 2.0)) and y.requires_grad
    (g,) = torch.autograd.grad(torch.sum(y * 3), [x])
    assert torch.equal(g, torch.full((2,), 3.0))


def test_vocab_parallel_greedy_ties_go_to_the_lowest_global_index(ranks):
    """On (1, 2) each rank's head (``model._head``: its vocab columns, the
    shards gathered in rank order by ``collectives.model_gather``) and the
    engine's argmax break ties between shards, and within one, by the
    lowest global index, as the one-process head does."""
    from repro_torch.core.engine import _argmax
    from repro_torch.models import model
    from repro_torch.parallel.sharding import local_context

    cfg = tpr.case_config("dense_1x2")
    h, params = tpr.tie_head(cfg)
    want = _argmax(model._head(params, h, cfg, local_context())).numpy()
    half = cfg.padded_vocab // 2
    assert want.tolist() == [[1], [half + 2]]
    for _, _, out in ranks[(1, 2)]:
        np.testing.assert_array_equal(out["ties"], want)
