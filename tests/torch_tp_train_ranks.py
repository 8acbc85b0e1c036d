"""The cases of ``test_torch_tp_train.py`` and their per-rank bodies:
module-level functions (the ``spawn`` start method pickles them by name)
that import only torch, numpy and the port. Each training rank builds its
``(data, model)`` mesh, takes its blocks of the JAX package's
padded-plan params, runs the port's gradient and two
``launch.train.build_train_step`` steps on the global batches, and
returns numpy arrays to the test. :func:`forms_rank` holds the backward
of each model-axis form against the one-process gradient of the same
function."""
from __future__ import annotations

import numpy as np
import torch

import torch_tp_ranks as tpr
from repro_torch import interop, optim
from repro_torch.configs import get_config, reduced
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import train
from repro_torch.models import postprocess_grads
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import compress as gc
from repro_torch.parallel.sharding import param_blocks, param_specs, \
    spec_axes
from repro_torch.tree import tree_map

DENSE, MOE = tpr.DENSE, tpr.MOE
BATCH, SEQ, CHUNK = tpr.BATCH, tpr.SEQ, tpr.CHUNK

# name -> the arch, the mesh, the config's overrides and the context's
# knobs; "compress" runs the steps with the int8 round trip. Two cases
# rematerialise their blocks, so the backward reissues the forward's
# collectives (the reduced configs do not remat)
CASES = {
    "dense_1x2": dict(arch=DENSE, mesh=(1, 2)),
    "dense_1x4": dict(arch=DENSE, mesh=(1, 4), cfg={"remat": True}),
    "dense_2x2": dict(arch=DENSE, mesh=(2, 2)),
    "dense_sp_2x2": dict(arch=DENSE, mesh=(2, 2), sp=True),
    "dense_sp_1x4": dict(arch=DENSE, mesh=(1, 4), sp=True),
    "dense_compress_2x2": dict(arch=DENSE, mesh=(2, 2), compress=True),
    "moe_ep_1x2": dict(arch=MOE, mesh=(1, 2), ep_shardmap=True),
    "moe_ep_sp_1x2": dict(arch=MOE, mesh=(1, 2), ep_shardmap=True, sp=True,
                          cfg={"remat": True}),
    "moe_tp_1x2": dict(arch=MOE, mesh=(1, 2), ep_shardmap=True,
                       cfg={"moe_impl": "tp"}),
    "moe_gspmd_ep_1x2": dict(arch=MOE, mesh=(1, 2)),
    "moe_gspmd_dff_1x2": dict(arch=MOE, mesh=(1, 2),
                              cfg={"moe_impl": "tp"}),
}
MESHES = sorted({c["mesh"] for c in CASES.values()})
STEPS = 2


def case_config(case):
    """The port's config of a case (the reduced config in f32)."""
    spec = CASES[case]
    return reduced(get_config(spec["arch"])).replace(
        dtype="float32", **spec.get("cfg", {}))


def case_context(case, mesh):
    spec = CASES[case]
    ctx = lmesh.make_context(mesh, case_config(case), sp=spec.get("sp", False))
    return ctx._replace(ep_shardmap=spec.get("ep_shardmap", False))


def batches(vocab):
    """The STEPS global batches (tokens, labels), (BATCH, SEQ) int32; the
    first is ``torch_tp_ranks.inputs``'."""
    out = [tpr.inputs(vocab)]
    rng = np.random.default_rng(8)
    for _ in range(STEPS - 1):
        toks = rng.integers(1, vocab, (BATCH, SEQ)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


def _batch(toks, labels):
    return {"tokens": torch.from_numpy(np.array(toks, copy=True)),
            "labels": torch.from_numpy(np.array(labels, copy=True))}


def _whole(tree, ctx):
    """The whole (padded global) arrays of a tree of this rank's model
    blocks: each split leaf's blocks gathered over the model axis."""
    def gather(x, spec):
        for d, e in enumerate(spec):
            if ctx.model_axis in spec_axes(e):
                return coll.all_gather(x, ctx.mesh, ctx.model_axis, d)
        return x

    return tree_map(gather, tree, param_specs(tree, ctx))


def _train_case(z, mesh, case):
    cfg = case_config(case)
    ctx = case_context(case, mesh)
    compress = CASES[case].get("compress", False)
    params = param_blocks(interop.lm_params_from_numpy(
        tpr._unflat(z, f"{case}/params/"), "cpu"), ctx)
    glob = [_batch(*b) for b in batches(cfg.vocab_size)]
    # the gradient of the global batch's loss: each data rank's, weighted
    # by its rows' share, summed over the data axis
    local = train.local_batch(glob[0], ctx)
    share = local["labels"].numel() / glob[0]["labels"].numel()
    loss, metrics, grads = train.grads_of(params, local, cfg, ctx,
                                          chunk=CHUNK)
    grads = postprocess_grads(grads, cfg, ctx)
    data = lambda t: coll.psum(t.float() * share, mesh, "data")  # noqa: E731
    grads = tree_map(data, grads)
    out = {"loss": float(data(loss)), "ce": float(data(metrics["ce"])),
           "aux": float(data(metrics["aux"])),
           "grad_norm": float(optim.global_norm(_whole(grads, ctx))),
           "grads": interop.to_numpy(grads)}
    ocfg = optim.AdamWConfig()
    opt = optim.zero1_init(params, ocfg, ctx)
    err = gc.init_error(opt.m) if compress else None
    step = train.build_train_step(cfg, ctx, ocfg, compress=compress,
                                  chunk=CHUNK)
    out["steps"] = []
    for b in glob:
        params, opt, err, m = step(params, opt, err, b)
        out["steps"].append({k: float(v) for k, v in m.items()})
    opt = optim.zero1_gather(opt, params, ctx)
    out.update(params=interop.to_numpy(params), m=interop.to_numpy(opt.m),
               v=interop.to_numpy(opt.v))
    return out


def train_rank(rank, world, params_path, shape, cases):
    """Every case of one mesh on this rank of it: (data, model) coords and
    each case's outputs."""
    z = np.load(params_path)
    mesh = lmesh.make_test_mesh(shape, ("data", "model"))
    out = {c: _train_case(z, mesh, c) for c in cases}
    return mesh.coord("data"), mesh.coord("model"), out


# ---------------------------------------------------------------------------
# The model-axis forms' backward against one process
# ---------------------------------------------------------------------------

FORMS = ("model_psum", "model_copy", "model_reduce", "model_gather",
         "model_block", "all_to_all")


def _form_inputs(n, device):
    """Seeded whole inputs of every form for a model axis of n ranks:
    x, w and the cotangent weights cw, cx (2n, 2n); the all-to-all's X
    and C (n, n, 3, 4)."""
    rng = np.random.default_rng(21)
    shapes = {"x": (2 * n, 2 * n), "w": (2 * n, 2 * n),
              "cw": (2 * n, 2 * n), "cx": (2 * n, 2 * n),
              "X": (n, n, 3, 4), "C": (n, n, 3, 4)}
    return {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .to(device) for k, s in shapes.items()}


def _blk(t, r, n, dim):
    k = t.shape[dim] // n
    return t.narrow(dim, r * k, k)


def _leaf(t):
    return t.detach().clone().requires_grad_()


def _grads(loss, leaves):
    return [g.detach().cpu() for g in torch.autograd.grad(loss, leaves)]


def form_case(form, ctx, device):
    """One form's gradients on this rank (of a (1, n) mesh's model axis)
    and the one-process gradients of the same function, blocks matched:
    (got, want), lists of numpy arrays. Each function ends in a loss
    every rank holds whole."""
    n, r = ctx.tp, coll.model_rank(ctx)
    v = _form_inputs(n, device)
    x, w = _leaf(v["x"]), _leaf(v["w"])
    cw, cx = v["cw"], v["cx"]
    if form == "model_psum":  # a row-split product's partials summed
        xb, wb = _leaf(_blk(v["x"], r, n, 1)), _leaf(_blk(v["w"], r, n, 0))
        y = coll.model_psum(xb @ wb, ctx)
        got = _grads(torch.sum(y * cw), [xb, wb])
        gx, gw = _grads(torch.sum((x @ w) * cw), [x, w])
        want = [_blk(gx, r, n, 1), _blk(gw, r, n, 0)]
    elif form == "model_copy":  # the input of a column-split product
        wb = _leaf(_blk(v["w"], r, n, 1))
        y = coll.model_copy(x, ctx) @ wb
        got = _grads(coll.model_psum(torch.sum(y * _blk(cw, r, n, 1)), ctx),
                     [x, wb])
        gx, gw = _grads(torch.sum((x @ w) * cw), [x, w])
        want = [gx, _blk(gw, r, n, 1)]
    elif form == "model_reduce":  # partials reduce-scattered on dim 0
        xb, wb = _leaf(_blk(v["x"], r, n, 1)), _leaf(_blk(v["w"], r, n, 0))
        y = coll.model_reduce(xb @ wb, ctx, seq_dim=0)
        got = _grads(coll.model_psum(torch.sum(y * _blk(cw, r, n, 0)), ctx),
                     [xb, wb])
        gx, gw = _grads(torch.sum((x @ w) * cw), [x, w])
        want = [_blk(gx, r, n, 1), _blk(gw, r, n, 0)]
    elif form == "model_gather":  # row blocks gathered whole
        xb = _leaf(_blk(v["x"], r, n, 0))
        y = coll.model_gather(torch.tanh(xb), ctx, 0)
        got = _grads(torch.sum(y * y * cx), [xb])
        (gx,) = _grads(torch.sum(torch.tanh(x) ** 2 * cx), [x])
        want = [_blk(gx, r, n, 0)]
    elif form == "model_block":  # this rank's rows of a whole tensor
        y = coll.model_block(torch.tanh(x), ctx, 0)
        got = _grads(coll.model_psum(
            torch.sum(y * y * _blk(cx, r, n, 0)), ctx), [x])
        want = _grads(torch.sum(torch.tanh(x) ** 2 * cx), [x])
    elif form == "all_to_all":  # rank r's block i goes to rank i
        xr = _leaf(v["X"][r])
        y = coll.all_to_all(xr, ctx.mesh, ctx.model_axis)
        got = _grads(coll.model_psum(torch.sum(y * v["C"][r]), ctx), [xr])
        X = _leaf(v["X"])
        (gX,) = _grads(torch.sum(X.transpose(0, 1) * v["C"]), [X])
        want = [gX[r]]
    else:
        raise ValueError(form)
    return [g.numpy() for g in got], [g.contiguous().numpy() for g in want]


def forms_rank(rank, world, device="cpu"):
    """Every form on this rank of a (1, world) mesh: {form: (got,
    want)}."""
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = lmesh.make_test_mesh((1, world), ("data", "model"))
    ctx = lmesh.make_context(mesh, None)
    return {f: form_case(f, ctx, device) for f in FORMS}
