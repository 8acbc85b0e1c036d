"""The port's training under Megatron tensor parallelism across gloo ranks
on the CPU, held against the JAX package's GSPMD train step.

JAX's references run once for the module in one subprocess with 8 forced
host devices, on meshes built with ``AxisType.Auto`` axes (as in
``test_torch_tp.py``): each case's params come from JAX's
``init_params`` at the mesh's padded head plan, placed by
``param_specs``; then JAX's jitted ``value_and_grad`` of ``loss_fn``
with ``postprocess_grads``, and two steps of its ``build_train_step``
(the ``roundtrip`` compression where the case says) on the global
batches. The subprocess writes the params first (``params.npz``), so the
port's ranks (``torch_tp_train_ranks``; one launch a mesh) run while JAX
computes. Each rank takes its blocks of the params
(``interop.lm_params_from_numpy``, then ``sharding.param_blocks``).

Tolerances: the loss, ce, aux and grad norm within 1e-5 relative; every
gradient leaf (each rank's block; over data ranks the share-weighted
sum) within 2e-5 of the leaf's largest |value| (the split products and
model-axis sums add in other orders than XLA's); the params, m and v
after two steps by ``test_torch_multirank.py``'s rule (1e-5 of the
leaf's scale, the params plus 1% of the summed rate: Adam moves an
element whose gradient is within rounding of zero by a ratio its last
bits decide). Replicated leaves and tied kv replicas equal bit for bit
across the model ranks."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import torch_tp_train_ranks as ttr
from repro_torch.parallel import collectives as coll

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANK_TIMEOUT = 60  # s, each collective's bound (and the launch's, + 60)
THREADS = 1
GRAD_TOL = 2e-5
JAX_TIMEOUT = 300  # s

JAX_REFS = r'''
import json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, AxisType

sys.path.insert(0, os.path.dirname(sys.argv[3]))
import torch_tp_train_ranks as ttr  # the case table
from repro.configs import get_config, reduced
from repro.launch.mesh import make_context
from repro.launch.train import build_train_step
from repro.models import model as M
from repro.optim import AdamWConfig, global_norm, init as opt_init
from repro.parallel import compress as gc
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
    batches = [{"tokens": jnp.asarray(t), "labels": jnp.asarray(l)}
               for t, l in ttr.batches(cfg.vocab_size)]

    def grads_of(p, b):
        (loss, m), g = jax.value_and_grad(M.loss_fn, has_aux=True)(
            p, b, cfg, ctx, chunk=ttr.CHUNK)
        return loss, m, M.postprocess_grads(g, cfg, ctx)

    loss, m, grads = jax.jit(grads_of)(pp, batches[0])
    res[case + "/loss"] = np.asarray(loss)
    res[case + "/ce"] = np.asarray(m["ce"])
    res[case + "/aux"] = np.asarray(m["aux"])
    res[case + "/grad_norm"] = np.asarray(jax.jit(global_norm)(grads))
    flat(grads, case + "/grads/")
    compress = spec.get("compress", False)
    ocfg = AdamWConfig()
    opt = opt_init(pp, ocfg)
    err = gc.init_error(pp) if compress else None
    step = build_train_step(cfg, ctx, ocfg, compress=compress,
                            chunk=ttr.CHUNK)
    for i, b in enumerate(batches):
        pp, opt, err, met = step(pp, opt, err, b)
        for k, v in met.items():
            res[f"{case}/step{i}/{k}"] = np.asarray(v)
    flat(pp, case + "/final/params/")
    flat(opt.m, case + "/final/m/")
    flat(opt.v, case + "/final/v/")
np.savez(os.path.join(out, "refs.npz"), **res)
print("refs OK")
'''


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's references, one subprocess with 8 forced host devices: every
    case's params first (``params.npz``), then the gradients and steps
    (``refs.npz``)."""
    out = tmp_path_factory.mktemp("tp_train_refs")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    with open(out / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(JAX_REFS), str(out),
             json.dumps(ttr.CASES), ttr.__file__],
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
    """One launch a mesh: {mesh shape: [(data, model, outputs), ...]}."""
    out = {}
    for shape in ttr.MESHES:
        cases = [c for c, s in ttr.CASES.items() if s["mesh"] == shape]
        out[shape] = coll.launch(
            ttr.train_rank, shape[0] * shape[1], backend="gloo",
            args=(params_path, shape, cases), timeout=RANK_TIMEOUT,
            num_threads=THREADS)
    return out


@pytest.fixture(scope="module")
def refs(jax_run, ranks):
    proc, out = jax_run
    assert proc.wait(timeout=JAX_TIMEOUT) == 0, _jax_failure(out)
    return dict(np.load(out / "refs.npz"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _close(got, want, what, tol=1e-5, slack=0.0):
    """``test_torch_multirank.py``'s rule: max |diff| within ``tol`` of
    the leaf's largest |value|, plus ``slack``."""
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= tol * scale + slack, \
        f"{what}: |diff| {err:.3e} > {tol} x {scale:.3e} + {slack:.1e}"


def _specs(case):
    """The port's param specs of a case at its mesh (an abstract mesh: the
    spec functions need no group)."""
    from repro_torch.models import model
    from repro_torch.parallel.sharding import Mesh, param_specs

    ctx = ttr.case_context(case, Mesh(ttr.CASES[case]["mesh"],
                                      ("data", "model")))
    return dict(_leaves(param_specs(model.abstract_params(
        ttr.case_config(case), ctx), ctx)))


def _model_block(want, spec, model, tp):
    """Model rank ``model``'s block of a whole array under ``spec``."""
    for d, e in enumerate(spec):
        if e == "model":
            k = want.shape[d] // tp
            return np.take(want, range(model * k, (model + 1) * k), axis=d)
    return want


def _each_rank(ranks, case):
    shape = ttr.CASES[case]["mesh"]
    for data, model, out in ranks[shape]:
        yield data, model, shape, out[case]


def _want(refs, case, prefix):
    pre = f"{case}/{prefix}/"
    return {k[len(pre):]: v for k, v in refs.items() if k.startswith(pre)}


CASES = list(ttr.CASES)


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grad_norm_match_jax_gspmd(refs, ranks, case):
    """The loss, ce and aux of the global batch and its gradient's norm
    (the padded global arrays') are JAX's within 1e-5 relative on every
    rank; so are both steps' losses and grad norms (after the round trip
    where the case compresses)."""
    for _, _, _, out in _each_rank(ranks, case):
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(out[k], refs[f"{case}/{k}"],
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(out["grad_norm"],
                                   refs[f"{case}/grad_norm"], rtol=1e-5)
        for i, m in enumerate(out["steps"]):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(m[k], refs[f"{case}/step{i}/{k}"],
                                           rtol=1e-5, err_msg=f"step {i} {k}")


@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax_gspmd(refs, ranks, case):
    """Every gradient leaf after ``postprocess_grads`` (the kv replicas
    tied across ranks) is this model rank's block of JAX's, within
    GRAD_TOL of the leaf's largest |value|; the data ranks' share-weighted
    sum is the global batch's gradient."""
    want = _want(refs, case, "grads")
    specs = _specs(case)
    for _, model, (_, tp), out in _each_rank(ranks, case):
        got = dict(_leaves(out["grads"]))
        assert got.keys() == want.keys(), case
        for k, g in got.items():
            w = _model_block(want[k], specs[k], model, tp)
            assert g.shape == w.shape, k
            _close(g, w, f"{case} grad {k} rank {model}", tol=GRAD_TOL)


@pytest.mark.parametrize("case", CASES)
def test_two_steps_match_jax_build_train_step(refs, ranks, case):
    """After two ``build_train_step`` steps each rank's params, m and v are
    its model blocks of JAX's (ZeRO-1 moments gathered over the data
    axis), by ``test_torch_multirank.py``'s rules. m and v within 1e-5 of
    the leaf's largest |value|; the params within that plus 1% of the
    summed rate. Adam moves an element whose gradient is within rounding
    of zero by m / (sqrt(v) + eps), a ratio the gradients' last bits
    decide, up to its whole step: an element past that bound must have
    its v under 1e-6 of the leaf's largest (its gradient under 1e-3 of
    the largest), and have moved by at most 2 x the summed rate. With the
    int8 round trip, the multirank compressed rules: the elements whose
    code flipped (at most 1% of a leaf) may differ by two codes of the
    larger step's gradient in m, by what two codes change v by in v,
    and by Adam's step in the params."""
    b2 = 0.95
    compress = ttr.CASES[case].get("compress", False)
    specs = _specs(case)
    for _, model, (_, tp), out in _each_rank(ranks, case):
        lr_sum = sum(m["lr"] for m in out["steps"])
        got, want = {}, {}
        for what in ("params", "m", "v"):
            full = _want(refs, case, f"final/{what}")
            got[what] = dict(_leaves(out[what]))
            want[what] = {k: _model_block(full[k], specs[k], model, tp)
                          for k in got[what]}
        for k, p in got["params"].items():
            w, v = want["params"][k], want["v"][k]
            what = f"{case} params {k} rank {model}"
            assert p.shape == w.shape, what
            scale = float(np.max(np.abs(w)))
            diff = np.abs(p.astype(np.float64) - w)
            off = diff > 1e-5 * scale + 1e-2 * lr_sum
            assert diff.max() <= 2 * lr_sum + 1e-5 * scale, what
            if compress:
                assert off.mean() <= 0.01, (what, off.mean())
            else:
                assert (v[off] <= 1e-6 * v.max()).all(), \
                    (what, int(off.sum()))
        for moment in ("m", "v"):
            for k, g in got[moment].items():
                w = want[moment][k]
                what = f"{case} {moment} {k} rank {model}"
                assert g.shape == w.shape, what
                if not compress:
                    _close(g, w, what)
                    continue
                code = np.sqrt(want["v"][k].max() / ((1 - b2) * b2)) / 127
                diff = np.abs(g.astype(np.float64) - w)
                off = diff > 1e-5 * max(float(np.abs(w).max()), 1e-30)
                assert off.mean() <= 0.01, (what, off.mean())
                bound = 2 * code if moment == "m" \
                    else 2 * (1 - b2) * 255 * code ** 2
                assert diff.max() <= bound * 1.001 + 1e-12, what


@pytest.mark.parametrize("case", CASES)
def test_replicated_leaves_and_kv_replicas_equal_across_ranks(ranks, case):
    """Leaves every model rank holds whole (norms, the router) are
    bit-equal across the ranks after two steps, as are their gradients;
    with kv replicated over ranks (``plan.repl`` > 1), the ranks holding
    replicas of one logical kv head hold the same wk/wv (and bk/bv) bits
    and the same tied gradients."""
    from repro_torch.models import transformer as tf
    from repro_torch.parallel.sharding import Mesh

    specs = _specs(case)
    shape = ttr.CASES[case]["mesh"]
    cfg = ttr.case_config(case)
    plan = tf.plan_for(cfg, ttr.case_context(case, Mesh(shape,
                                                        ("data", "model"))))
    kv_loc = plan.kv_phys // shape[1]
    outs = list(_each_rank(ranks, case))
    base = outs[0][3]
    replicated = [k for k, s in specs.items() if "model" not in s]
    assert replicated, case
    for _, model, _, out in outs[1:]:
        for what in ("params", "grads"):
            a, b = dict(_leaves(base[what])), dict(_leaves(out[what]))
            for k in replicated:
                np.testing.assert_array_equal(a[k], b[k],
                                              err_msg=f"{what} {k}")
    if plan.repl == 1:
        return
    # the ranks whose kv block holds replicas of the same logical head
    groups = {}
    for _, model, _, out in outs:
        head = model * kv_loc // plan.repl
        groups.setdefault(head, []).append(out)
    kv = [k for k in specs if k.split("/")[-1] in ("wk", "wv", "bk", "bv")]
    assert kv and any(len(g) > 1 for g in groups.values()), case
    for group in groups.values():
        for out in group[1:]:
            for what in ("params", "grads"):
                a, b = dict(_leaves(group[0][what])), dict(_leaves(out[what]))
                for k in kv:
                    np.testing.assert_array_equal(a[k], b[k],
                                                  err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def forms():
    """Every form's backward on each rank of a (1, 2) and a (1, 4) mesh."""
    return {world: coll.launch(ttr.forms_rank, world, backend="gloo",
                               timeout=RANK_TIMEOUT, num_threads=THREADS)
            for world in (2, 4)}


@pytest.mark.parametrize("form", ttr.FORMS)
def test_model_axis_form_backward_matches_one_process(forms, form):
    """Each form's gradient on every rank (a block, or the whole input the
    ranks hold whole) against the one-process gradient of the same
    function, within 1e-6 of its scale; a tensor every rank holds whole
    gets the same bits on every rank."""
    for world, outs in forms.items():
        for r, res in enumerate(outs):
            got, want = res[form]
            for a, b in zip(got, want):
                assert a.shape == b.shape, (world, r, form)
                _close(a, b, f"{form} world {world} rank {r}", tol=1e-6)
        if form in ("model_copy", "model_block"):
            for res in outs[1:]:
                np.testing.assert_array_equal(res[form][0][0],
                                              outs[0][form][0][0])
