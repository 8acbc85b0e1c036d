"""The cases of ``test_torch_dp_moe.py`` and their per-rank bodies:
module-level functions (the ``spawn`` start method pickles them by name)
that import only torch, numpy and the port. Each rank builds its
``(data, model)`` mesh with a data axis of 2, takes its blocks of the
JAX package's padded-plan params and its rows of the inputs, runs the
port's MoE serving steps, two ``launch.train.build_train_step`` steps
and the aux loss's router gradient, and returns numpy arrays.

Every case is the reduced Qwen3-MoE config (4 experts, top 2) at
capacity factor 1.0, so the capacity drops assignments: the capacity,
the dispatch positions and the router statistics are the whole batch's
(GSPMD ``moe_apply``) or the rank's (the ``shard_map`` dispatches)."""
from __future__ import annotations

import numpy as np
import torch

import torch_tp_ranks as tpr
import torch_tp_train_ranks as ttr
from repro_torch import interop, optim
from repro_torch.configs import get_config, reduced
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import train
from repro_torch.models import model, moe, postprocess_grads
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import param_blocks
from repro_torch.tree import tree_map

MOE = tpr.MOE
BATCH, SEQ, CHUNK = tpr.BATCH, tpr.SEQ, tpr.CHUNK
CACHE_LEN = tpr.CACHE_LEN
CF = 1.0  # the capacity factor: JAX drops assignments at it
PREFIX = 2  # rows of the admitted-prefix prefill_kv (1 a data rank)

GSPMD_PARTS = ("fwd", "decode", "prefill_kv", "train", "aux_grad")
SHARDMAP_PARTS = ("train", "aux_grad")
# name -> the mesh, the config's overrides, the context's knobs and what
# runs: the serving steps ("fwd", "decode", "prefill_kv"), two train
# steps ("train") and the aux loss's router gradient ("aux_grad").
# "ep" is the config's own expert layout (the EP weight specs), "dff"
# the expert d_ff over the model axis (moe_impl "tp"); "ep_shardmap" and
# "tp_shardmap" the JAX package's explicit dispatches
CASES = {
    "gspmd_ep_2x1": dict(mesh=(2, 1), parts=GSPMD_PARTS),
    "gspmd_dff_2x1": dict(mesh=(2, 1), cfg={"moe_impl": "tp"},
                          parts=GSPMD_PARTS),
    "gspmd_ep_2x2": dict(mesh=(2, 2), parts=GSPMD_PARTS),
    "gspmd_dff_2x2": dict(mesh=(2, 2), cfg={"moe_impl": "tp"},
                          parts=GSPMD_PARTS),
    "ep_shardmap_2x1": dict(mesh=(2, 1), ep_shardmap=True,
                            parts=SHARDMAP_PARTS),
    "ep_shardmap_2x2": dict(mesh=(2, 2), ep_shardmap=True,
                            parts=SHARDMAP_PARTS),
    "tp_shardmap_2x1": dict(mesh=(2, 1), ep_shardmap=True,
                            cfg={"moe_impl": "tp"}, parts=SHARDMAP_PARTS),
    "tp_shardmap_2x2": dict(mesh=(2, 2), ep_shardmap=True,
                            cfg={"moe_impl": "tp"}, parts=SHARDMAP_PARTS),
}
MESHES = sorted({c["mesh"] for c in CASES.values()})


def case_config(case):
    """The port's config of a case (the reduced config in f32 at CF)."""
    return reduced(get_config(MOE)).replace(
        dtype="float32", capacity_factor=CF, **CASES[case].get("cfg", {}))


def case_context(case, mesh):
    spec = CASES[case]
    ctx = lmesh.make_context(mesh, case_config(case))
    return ctx._replace(ep_shardmap=spec.get("ep_shardmap", False))


def dispatch_of(case):
    """The layer function a case's stateless block runs."""
    spec = CASES[case]
    if not spec.get("ep_shardmap"):
        return "moe_apply"
    return "moe_apply_tp_shardmap" if spec.get("cfg") else \
        "moe_apply_ep_shardmap"


def aux_input(d_model):
    """The aux gradient's layer input, (BATCH, SEQ, D) f32."""
    rng = np.random.default_rng(13)
    return rng.normal(size=(BATCH, SEQ, d_model)).astype(np.float32)


def _serve(params, cfg, ctx, mesh, parts):
    toks, labels = tpr.inputs(cfg.vocab_size)
    tk, lb = tpr._rows(toks, mesh), tpr._rows(labels, mesh)
    out = {}
    if "fwd" in parts:
        logits, aux = model.forward(params, tk, cfg, ctx, chunk=CHUNK)
        loss, m = model.loss_fn(params, {"tokens": tk, "labels": lb}, cfg,
                                ctx, chunk=CHUNK)
        out.update(fwd=logits.numpy(), aux=float(aux), loss=float(loss),
                   ce=float(m["ce"]))
    if "decode" in parts:
        st = model.make_decode_state(cfg, ctx, BATCH, CACHE_LEN, "cpu")
        st, last = model.prefill(params, tk, st, cfg, ctx, chunk=CHUNK)
        logits = [last.numpy()]
        for tok in tpr.fed_tokens(cfg.vocab_size):
            st, lg = model.decode_step(params, tpr._rows(tok, mesh), st, cfg,
                                       ctx)
            logits.append(lg.numpy())
        out.update(decode_logits=np.stack(logits), k=st.layers["k"].numpy(),
                   v=st.layers["v"].numpy(), pos=st.pos.numpy())
    if "prefill_kv" in parts:
        k, v, last = model.prefill_kv(params, tk, cfg, ctx, chunk=CHUNK)
        out.update(pkv_k=k.numpy(), pkv_v=v.numpy(), pkv_last=last.numpy())
        # the admitted prefix (PREFIX of the BATCH rows), its capacity the
        # whole padded batch's: what the paged engine's admission runs
        k, v, last = model.prefill_kv(
            params, tpr._rows(toks[:PREFIX], mesh), cfg, ctx, chunk=CHUNK,
            capacity_tokens=BATCH * SEQ)
        out.update(prefix_k=k.numpy(), prefix_v=v.numpy(),
                   prefix_last=last.numpy())
    return out


def _train(params, cfg, ctx, mesh):
    """ttr's training body: the global batch's loss and gradient (each
    data rank's, weighted by its rows' share, summed over the data axis),
    then two ``build_train_step`` steps."""
    glob = [ttr._batch(*b) for b in ttr.batches(cfg.vocab_size)]
    local = train.local_batch(glob[0], ctx)
    share = local["labels"].numel() / glob[0]["labels"].numel()
    loss, metrics, grads = train.grads_of(params, local, cfg, ctx,
                                          chunk=CHUNK)
    grads = postprocess_grads(grads, cfg, ctx)
    data = lambda t: coll.psum(t.float() * share, mesh, "data")  # noqa: E731
    grads = tree_map(data, grads)
    out = {"loss": float(data(loss)), "ce": float(data(metrics["ce"])),
           "aux": float(data(metrics["aux"])),
           "grad_norm": float(optim.global_norm(ttr._whole(grads, ctx))),
           "grads": interop.to_numpy(grads)}
    ocfg = optim.AdamWConfig()
    opt = optim.zero1_init(params, ocfg, ctx)
    step = train.build_train_step(cfg, ctx, ocfg, chunk=CHUNK)
    out["steps"] = []
    for b in glob:
        params, opt, _, m = step(params, opt, None, b)
        out["steps"].append({k: float(v) for k, v in m.items()})
    opt = optim.zero1_gather(opt, params, ctx)
    out.update(params=interop.to_numpy(params), m=interop.to_numpy(opt.m),
               v=interop.to_numpy(opt.v))
    return out


def _aux_grad(params, cfg, ctx, mesh, case):
    """The router's gradient of layer 0's aux loss alone on this rank's
    rows of ``aux_input``, weighted by the rows' share and summed over the
    data axis: the whole batch's aux gradient."""
    mp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    router = mp["router"].detach().clone().requires_grad_()
    x = tpr._rows(aux_input(cfg.d_model), mesh)
    fn = getattr(moe, dispatch_of(case))
    with torch.enable_grad():
        _, aux = fn({**mp, "router": router}, x, cfg, ctx)
        (g,) = torch.autograd.grad(aux / ctx.dp, [router])
    return {"aux_only": float(aux),
            "router_grad": coll.psum(g, mesh, "data").numpy()}


def _case(z, mesh, case):
    cfg = case_config(case)
    ctx = case_context(case, mesh)
    params = param_blocks(interop.lm_params_from_numpy(
        tpr._unflat(z, f"{case}/params/"), "cpu"), ctx)
    parts = CASES[case]["parts"]
    with torch.no_grad():
        out = _serve(params, cfg, ctx, mesh, parts)
    if "train" in parts:
        out["train"] = _train(params, cfg, ctx, mesh)
    if "aux_grad" in parts:
        out.update(_aux_grad(params, cfg, ctx, mesh, case))
    return out


def dp_rank(rank, world, params_path, shape, cases):
    """Every case of one mesh on this rank of it: (data, model) coords and
    each case's outputs."""
    z = np.load(params_path)
    mesh = lmesh.make_test_mesh(shape, ("data", "model"))
    out = {c: _case(z, mesh, c) for c in cases}
    return mesh.coord("data"), mesh.coord("model"), out
