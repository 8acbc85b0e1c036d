"""The port's data-parallel MoE across gloo ranks on the CPU, held against
the JAX package's GSPMD steps: serving and training on meshes with a
data axis of 2 (``(2, 1)`` and ``(2, 2)``), where the capacity, the
dispatch positions and the router statistics are the whole batch's.

JAX's references run once for the module in one subprocess with 8 forced
host devices on ``AxisType.Auto`` meshes (as in ``test_torch_tp.py``):
each case's params from JAX's ``init_params`` placed by
``param_specs``; then JAX's jitted ``forward``, ``loss_fn``,
``prefill``, ``decode_step`` and ``prefill_kv``, the gradient and two
``build_train_step`` steps, and ``jax.grad`` of one MoE layer's aux loss
with respect to its router. The subprocess wraps the three MoE layer
functions of the JAX package (in its own process: nothing of the package
changes) so that each call hands its router's choices to the host
(``jax.debug.callback``), where the dispatch's capacity rule counts the
assignments it drops: every case runs at capacity factor 1.0 and must
drop. The port's ranks (``torch_dp_moe_ranks``; one launch a mesh) run
while JAX computes, from the params it writes first.

Tolerances: ``test_torch_tp.py``'s for serving (2e-5; the loss 1e-5
relative), ``test_torch_tp_train.py``'s for training; the aux gradient
within 1e-5 of its largest |value|."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import torch_dp_moe_ranks as dmr
from repro_torch.parallel import collectives as coll

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
RANK_TIMEOUT = 60  # s, each collective's bound (and the launch's, + 60)
THREADS = 1
TOL = 2e-5
GRAD_TOL = 2e-5
JAX_TIMEOUT = 300  # s

JAX_REFS = r'''
import json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, AxisType, PartitionSpec as P

sys.path.insert(0, os.path.dirname(sys.argv[3]))
import torch_dp_moe_ranks as dmr  # the case table
import torch_tp_ranks as tpr
import torch_tp_train_ranks as ttr
from repro.configs import get_config, reduced
from repro.launch.mesh import make_context
from repro.launch.train import build_train_step
from repro.models import model as M
from repro.models import moe as jm
from repro.optim import AdamWConfig, global_norm, init as opt_init
from repro.parallel.sharding import param_specs

out, cases = sys.argv[1], json.loads(sys.argv[2])
devs = np.array(jax.devices())
assert len(devs) == 8, devs
res = {}
DROPS, LABEL = {}, [None]


def positions(e):
    """Each element's stable slot among the equal elements before it."""
    e = np.asarray(e)
    order = np.argsort(e, kind="stable")
    s = e[order]
    pos = np.empty(len(e), np.int64)
    pos[order] = np.arange(len(e)) - np.searchsorted(s, s, side="left")
    return pos


def dropped(kind, idx, cfg, shape):
    """The assignments a dispatch drops, from the router's choices ``idx``
    (T, k) of the global batch in token order, by the dispatch's own
    capacity rule (the JAX package's ``_capacity``)."""
    dp, tp = shape
    e = cfg.num_experts
    idx = np.asarray(idx)
    if kind == "moe_apply":  # the whole batch's buffers
        return int((positions(idx.reshape(-1))
                    >= jm._capacity(idx.shape[0], cfg, e)).sum())
    blocks = np.split(idx, dp)  # the data ranks' tokens
    if kind == "moe_apply_tp_shardmap":  # each data rank's buffers
        return sum(int((positions(b.reshape(-1))
                        >= jm._capacity(b.shape[0], cfg, e)).sum())
                   for b in blocks)
    # EP: each model rank routes its 1/tp of the data rank's tokens into
    # a send buffer a destination rank, then an expert's buffer there
    e_loc, n = e // tp, 0
    for b in blocks:
        recv = [[] for _ in range(tp)]
        for xm in np.split(b, tp):
            fe = xm.reshape(-1)
            dest = fe // e_loc
            cap_s = jm._capacity(xm.shape[0], cfg, tp)
            pos = positions(dest)
            keep = pos < cap_s
            n += int((~keep).sum())
            for j in range(tp):
                slots = np.full(cap_s, -1)
                sel = keep & (dest == j)
                slots[pos[sel]] = fe[sel] % e_loc
                recv[j].append(slots)
        cap2 = jm._capacity(tp * cap_s, cfg.replace(num_experts_per_tok=1),
                            e_loc)
        for j in range(tp):
            r = np.concatenate(recv[j])
            n += int((positions(r[r >= 0]) >= cap2).sum())
    return n


def counting(kind):
    orig = getattr(jm, kind)

    def wrapped(params, x, cfg, ctx, **kw):
        if not kw.get("no_drop"):
            d = x.shape[-1]
            _, idx, _, _ = jm._route_raw({"router": params["router"]},
                                         x.reshape(-1, d), cfg)
            shape = (ctx.mesh.shape["data"], ctx.mesh.shape["model"])

            def record(i):
                DROPS[LABEL[0]] = DROPS.get(LABEL[0], 0) + dropped(
                    kind, i, cfg, shape)

            jax.debug.callback(record, idx)
        return orig(params, x, cfg, ctx, **kw)

    setattr(jm, kind, wrapped)


for kind in ("moe_apply", "moe_apply_ep_shardmap", "moe_apply_tp_shardmap"):
    counting(kind)


def labelled(label, fn, *args):
    LABEL[0] = label
    y = jax.block_until_ready(fn(*args))
    jax.effects_barrier()
    res["dropped/" + label] = np.asarray(DROPS.get(label, 0))
    return y


def mesh_of(shape):
    n = shape[0] * shape[1]
    return Mesh(devs[:n].reshape(shape), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)


def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/".join(str(k.key) for k in path)] = np.asarray(leaf)


def setup(case, spec):
    cfg = reduced(get_config(dmr.MOE)).replace(
        dtype="float32", capacity_factor=dmr.CF, **spec.get("cfg", {}))
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
    parts = spec["parts"]
    toks, labels = (jnp.asarray(a) for a in tpr.inputs(cfg.vocab_size))
    if "fwd" in parts:
        (logits, aux), (loss, m) = labelled(case + "/fwd", jax.jit(
            lambda p, t, l: (
                M.forward(p, t, cfg, ctx, chunk=dmr.CHUNK),
                M.loss_fn(p, {"tokens": t, "labels": l}, cfg, ctx,
                          chunk=dmr.CHUNK))), pp, toks, labels)
        res[case + "/fwd"] = np.asarray(logits)
        res[case + "/aux"] = np.asarray(aux)
        res[case + "/loss"] = np.asarray(loss)
        res[case + "/ce"] = np.asarray(m["ce"])
    if "decode" in parts:
        st = M.make_decode_state(cfg, ctx, dmr.BATCH, dmr.CACHE_LEN)
        st, last = labelled(case + "/prefill", jax.jit(
            lambda p, t, s: M.prefill(p, t, s, cfg, ctx, chunk=dmr.CHUNK)),
            pp, toks, st)
        dec = jax.jit(lambda p, t, s: M.decode_step(p, t, s, cfg, ctx))
        logits = [np.asarray(last)]
        for tok in tpr.fed_tokens(cfg.vocab_size):
            st, lg = dec(pp, jnp.asarray(tok), st)
            logits.append(np.asarray(lg))
        res[case + "/decode_logits"] = np.stack(logits)
        res[case + "/k"] = np.asarray(st.layers["k"])
        res[case + "/v"] = np.asarray(st.layers["v"])
        res[case + "/pos"] = np.asarray(st.pos)
    if "prefill_kv" in parts:
        k, v, last = labelled(case + "/prefill_kv", jax.jit(
            lambda p, t: M.prefill_kv(p, t, cfg, ctx, chunk=dmr.CHUNK)),
            pp, toks)
        res[case + "/pkv_k"] = np.asarray(k)
        res[case + "/pkv_v"] = np.asarray(v)
        res[case + "/pkv_last"] = np.asarray(last)
    if "aux_grad" in parts:
        fn = getattr(jm, dmr.dispatch_of(case))
        x = jax.device_put(jnp.asarray(dmr.aux_input(cfg.d_model)),
                           NamedSharding(mesh, P("data", None, None)))

        def aux_of(p, x):
            mp = jax.tree_util.tree_map(lambda a: a[0], p["layers"]["moe"])

            def f(r):
                return fn({**mp, "router": r}, x, cfg, ctx)[1]

            return f(mp["router"]), jax.grad(f)(mp["router"])

        aux, g = labelled(case + "/aux_grad", jax.jit(aux_of), pp, x)
        res[case + "/aux_only"] = np.asarray(aux)
        res[case + "/router_grad"] = np.asarray(g)
    if "train" in parts:
        batches = [{"tokens": jnp.asarray(t), "labels": jnp.asarray(l)}
                   for t, l in ttr.batches(cfg.vocab_size)]

        def grads_of(p, b):
            (loss, m), g = jax.value_and_grad(M.loss_fn, has_aux=True)(
                p, b, cfg, ctx, chunk=dmr.CHUNK)
            return loss, m, M.postprocess_grads(g, cfg, ctx)

        loss, m, grads = labelled(case + "/train", jax.jit(grads_of), pp,
                                  batches[0])
        res[case + "/loss"] = np.asarray(loss)
        res[case + "/ce"] = np.asarray(m["ce"])
        res[case + "/aux"] = np.asarray(m["aux"])
        res[case + "/grad_norm"] = np.asarray(jax.jit(global_norm)(grads))
        flat(grads, case + "/grads/")
        ocfg = AdamWConfig()
        opt = opt_init(pp, ocfg)
        step = build_train_step(cfg, ctx, ocfg, chunk=dmr.CHUNK)
        cur = pp  # donated by the step
        for i, b in enumerate(batches):
            cur, opt, _, met = step(cur, opt, None, b)
            for k, v in met.items():
                res[f"{case}/step{i}/{k}"] = np.asarray(v)
        flat(cur, case + "/final/params/")
        flat(opt.m, case + "/final/m/")
        flat(opt.v, case + "/final/v/")
np.savez(os.path.join(out, "refs.npz"), **res)
print("refs OK")
'''


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's references, one subprocess with 8 forced host devices: every
    case's params first (``params.npz``), then the steps (``refs.npz``)."""
    out = tmp_path_factory.mktemp("dp_moe_refs")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    with open(out / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(JAX_REFS), str(out),
             json.dumps(dmr.CASES), dmr.__file__],
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
    for shape in dmr.MESHES:
        cases = [c for c, s in dmr.CASES.items() if s["mesh"] == shape]
        out[shape] = coll.launch(
            dmr.dp_rank, shape[0] * shape[1], backend="gloo",
            args=(params_path, shape, cases), timeout=RANK_TIMEOUT,
            num_threads=THREADS)
    return out


@pytest.fixture(scope="module")
def refs(jax_run, ranks):
    proc, out = jax_run
    assert proc.wait(timeout=JAX_TIMEOUT) == 0, _jax_failure(out)
    return dict(np.load(out / "refs.npz"))


def _near(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _scaled(got, want, what, tol=1e-5, slack=0.0):
    """max |diff| within ``tol`` of the leaf's largest |value|, plus
    ``slack`` (``test_torch_multirank.py``'s rule)."""
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= tol * scale + slack, \
        f"{what}: |diff| {err:.3e} > {tol} x {scale:.3e} + {slack:.1e}"


def _rows(x, data, dp, axis=0):
    b = x.shape[axis] // dp
    return np.take(x, range(data * b, (data + 1) * b), axis=axis)


def _each_rank(ranks, case):
    shape = dmr.CASES[case]["mesh"]
    for data, model, out in ranks[shape]:
        yield data, model, shape, out[case]


def _kv_block(full, data, model, shape, batch_axis):
    """Rank (data, model)'s rows and kv heads of JAX's (L, B, S, KV, hd)
    k or v."""
    dp, tp = shape
    kv = full.shape[3] // tp
    return _rows(full, data, dp, batch_axis)[:, :, :, model * kv:
                                             (model + 1) * kv]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _want(refs, case, prefix):
    pre = f"{case}/{prefix}/"
    return {k[len(pre):]: v for k, v in refs.items() if k.startswith(pre)}


def _specs(case):
    from repro_torch.models import model
    from repro_torch.parallel.sharding import Mesh, param_specs

    ctx = dmr.case_context(case, Mesh(dmr.CASES[case]["mesh"],
                                      ("data", "model")))
    return dict(_leaves(param_specs(model.abstract_params(
        dmr.case_config(case), ctx), ctx)))


def _model_block(want, spec, model, tp):
    for d, e in enumerate(spec):
        if e == "model":
            k = want.shape[d] // tp
            return np.take(want, range(model * k, (model + 1) * k), axis=d)
    return want


SERVE = [c for c, s in dmr.CASES.items() if "fwd" in s["parts"]]
CASES = list(dmr.CASES)


def test_moe_at_one_model_rank_takes_the_whole_batch(refs, ranks):
    """On a (2, 1) mesh GSPMD ``moe_apply`` sizes the capacity, places the
    assignments and averages the router statistics over the whole batch,
    as JAX's GSPMD step does (a rank's rows alone give another capacity,
    other drops and another aux loss): each rank's ``forward`` logits and
    ``prefill_kv`` k, v and logits are its rows of JAX's, the aux loss
    JAX's global one, and JAX dropped assignments in both calls."""
    case = "gspmd_ep_2x1"
    for part in ("fwd", "prefill_kv"):
        assert refs[f"dropped/{case}/{part}"] > 0, part
    for data, _, (dp, _), out in _each_rank(ranks, case):
        _near(out["fwd"], _rows(refs[case + "/fwd"], data, dp), "fwd")
        np.testing.assert_allclose(out["aux"], refs[case + "/aux"],
                                   rtol=1e-5, atol=1e-7)
        for f in ("k", "v"):
            _near(out["pkv_" + f], _rows(refs[f"{case}/pkv_{f}"], data, dp,
                                         1), f"prefill_kv {f}")
        _near(out["pkv_last"], _rows(refs[case + "/pkv_last"], data, dp),
              "prefill_kv logits")


@pytest.mark.parametrize("case", CASES)
def test_jax_drops_assignments_in_every_case(refs, case):
    """At capacity factor 1.0 JAX's dispatch drops assignments in every
    part a case runs (counted from its router's choices by the dispatch's
    capacity rule), so each comparison below covers the drops."""
    parts = [p for p in dmr.CASES[case]["parts"] if p != "decode"]
    if "decode" in dmr.CASES[case]["parts"]:
        parts.append("prefill")
    for part in parts:
        assert refs[f"dropped/{case}/{part}"] > 0, part


@pytest.mark.parametrize("case", SERVE)
def test_forward_and_loss_match_jax_gspmd(refs, ranks, case):
    """Each rank's forward logits are JAX's of its rows within TOL, equal
    across its model ranks; the data ranks' losses average to JAX's and
    the aux loss is JAX's global one on every rank (1e-5 relative)."""
    by_data = {}
    for data, _, (dp, _), out in _each_rank(ranks, case):
        _near(out["fwd"], _rows(refs[case + "/fwd"], data, dp),
              f"{case} fwd {data}")
        np.testing.assert_allclose(out["aux"], refs[case + "/aux"],
                                   rtol=1e-5, atol=1e-7)
        by_data.setdefault(data, []).append(out)
    loss = np.mean([v[0]["loss"] for v in by_data.values()])
    np.testing.assert_allclose(loss, refs[case + "/loss"], rtol=1e-5)
    for outs in by_data.values():
        for o in outs[1:]:
            np.testing.assert_array_equal(o["fwd"], outs[0]["fwd"])


@pytest.mark.parametrize("case", SERVE)
def test_prefill_and_decode_match_jax_gspmd(refs, ranks, case):
    """prefill (drops at the whole batch's capacity), then teacher-forced
    decode steps (``no_drop``): every step's logits within TOL of JAX's
    rows, the rings this rank's rows and kv heads of JAX's, positions
    equal."""
    want = refs[case + "/decode_logits"]
    for data, model, shape, out in _each_rank(ranks, case):
        _near(out["decode_logits"], _rows(want, data, shape[0], 1),
              f"{case} decode {data, model}")
        for f in ("k", "v"):
            _near(out[f], _kv_block(refs[f"{case}/{f}"], data, model, shape,
                                    1), f"{case} {f}")
        np.testing.assert_array_equal(
            out["pos"], _rows(refs[case + "/pos"], data, shape[0]))


@pytest.mark.parametrize("case", SERVE)
def test_prefill_kv_and_admitted_prefix_match_jax_gspmd(refs, ranks, case):
    """``prefill_kv`` of the whole batch is JAX's (k, v on this rank's
    rows and kv heads, last logits), and of the admitted prefix (PREFIX
    rows, one a data rank) with ``capacity_tokens`` the padded batch's is
    JAX's whole-batch prefill's first rows: the prefix comes first in
    token order and each rank's positions are offset by the earlier
    ranks' counts."""
    for data, model, shape, out in _each_rank(ranks, case):
        dp = shape[0]
        for f in ("k", "v"):
            full = refs[f"{case}/pkv_{f}"]
            _near(out["pkv_" + f], _kv_block(full, data, model, shape, 1),
                  f"{case} prefill_kv {f}")
            _near(out["prefix_" + f],
                  _kv_block(full[:, :dmr.PREFIX], data, model, shape, 1),
                  f"{case} prefix {f}")
        last = refs[case + "/pkv_last"]
        _near(out["pkv_last"], _rows(last, data, dp), f"{case} last")
        _near(out["prefix_last"], _rows(last[:dmr.PREFIX], data, dp),
              f"{case} prefix last")


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grad_norm_match_jax_build_train_step(refs, ranks, case):
    """The global batch's loss, ce and aux and its gradient's norm are
    JAX's within 1e-5 relative on every rank; so are both steps' losses
    and grad norms."""
    for _, _, _, out in _each_rank(ranks, case):
        tr = out["train"]
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(tr[k], refs[f"{case}/{k}"],
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(tr["grad_norm"],
                                   refs[f"{case}/grad_norm"], rtol=1e-5)
        for i, m in enumerate(tr["steps"]):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(m[k], refs[f"{case}/step{i}/{k}"],
                                           rtol=1e-5, err_msg=f"step {i} {k}")


@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax_gspmd(refs, ranks, case):
    """Every gradient leaf, summed over the data ranks (each weighted by
    its rows' share), is this model rank's block of JAX's within
    GRAD_TOL of the leaf's largest |value|."""
    want = _want(refs, case, "grads")
    specs = _specs(case)
    for _, model, (_, tp), out in _each_rank(ranks, case):
        got = dict(_leaves(out["train"]["grads"]))
        assert got.keys() == want.keys(), case
        for k, g in got.items():
            w = _model_block(want[k], specs[k], model, tp)
            assert g.shape == w.shape, k
            _scaled(g, w, f"{case} grad {k} rank {model}", tol=GRAD_TOL)


@pytest.mark.parametrize("case", CASES)
def test_two_steps_match_jax_build_train_step(refs, ranks, case):
    """After two steps each rank's params, m and v are its model blocks of
    JAX's (the ZeRO-1 moments gathered over the data axis), by
    ``test_torch_tp_train.py``'s rule: m and v within 1e-5 of the leaf's
    largest |value|, the params within that plus 1% of the summed rate,
    an element past it only where its v is under 1e-6 of the leaf's
    largest (a gradient within rounding of zero), and never past 2 x the
    summed rate."""
    specs = _specs(case)
    for _, model, (_, tp), out in _each_rank(ranks, case):
        tr = out["train"]
        lr_sum = sum(m["lr"] for m in tr["steps"])
        got, want = {}, {}
        for what in ("params", "m", "v"):
            full = _want(refs, case, f"final/{what}")
            got[what] = dict(_leaves(tr[what]))
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
            assert (v[off] <= 1e-6 * v.max()).all(), (what, int(off.sum()))
        for moment in ("m", "v"):
            for k, g in got[moment].items():
                w = want[moment][k]
                assert g.shape == w.shape, (moment, k)
                _scaled(g, w, f"{case} {moment} {k} rank {model}")


@pytest.mark.parametrize("case", CASES)
def test_replicated_leaves_equal_across_model_ranks(ranks, case):
    """Leaves every model rank holds whole (norms, the router) are
    bit-equal across the model ranks after two steps, as are their
    gradients; every rank's params are equal across the data ranks."""
    specs = _specs(case)
    replicated = [k for k, s in specs.items() if "model" not in s]
    assert replicated, case
    outs = list(_each_rank(ranks, case))
    by_model = {}
    for _, model, _, out in outs:
        by_model.setdefault(model, []).append(out["train"])
    for what in ("params", "grads"):
        base = dict(_leaves(outs[0][3]["train"][what]))
        for _, _, _, out in outs[1:]:
            other = dict(_leaves(out["train"][what]))
            for k in replicated:
                np.testing.assert_array_equal(base[k], other[k],
                                              err_msg=f"{what} {k}")
    for same in by_model.values():
        a = dict(_leaves(same[0]["params"]))
        for tr in same[1:]:
            for k, x in _leaves(tr["params"]):
                np.testing.assert_array_equal(a[k], x, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_aux_router_gradient_matches_jax_grad(refs, ranks, case):
    """The router's gradient of one MoE layer's aux loss alone (each
    rank's weighted by its rows' share, summed over the data axis) is
    ``jax.grad`` of JAX's aux within 1e-5 of its largest |value|, and
    the aux JAX's. The data axis's mean of the router statistics sums the
    ranks' cotangents in its backward: an identity backward, the model
    axis's rule, would give 1/dp of this."""
    want = refs[case + "/router_grad"]
    assert np.abs(want).max() > 0, case
    for data, model, _, out in _each_rank(ranks, case):
        np.testing.assert_allclose(out["aux_only"], refs[case + "/aux_only"],
                                   rtol=1e-5, atol=1e-7)
        _scaled(out["router_grad"], want, f"{case} rank {data, model}")
