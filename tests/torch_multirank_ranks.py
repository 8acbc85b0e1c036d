"""Per-rank bodies of ``test_torch_multirank.py``: module-level functions
(the ``spawn`` start method pickles them by name) that import only torch,
numpy and the port. Each runs on one gloo rank of a CPU mesh and returns
numpy arrays or plain data to the test."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import interop
from repro_torch.checkpoint import checkpointer, elastic
from repro_torch.configs import get_config, reduced
from repro_torch.core import transaction as tx
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import train as ltrain
from repro_torch.models import moe as moe_mod
from repro_torch.optim import AdamWConfig, zero1_gather, zero1_init
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import compress as gc
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.parallel.sharding import (
    NamedSharding, P, ParallelContext, shard_block,
)


def rank_input(rank: int) -> torch.Tensor:
    """Each rank's (4, 2) f32 input: 0..7 plus 100 x rank."""
    return torch.arange(8, dtype=torch.float32).reshape(4, 2) + 100 * rank


def collectives_rank(rank, world, device="cpu"):
    """Every collective on a (2, 2) ("data", "model") mesh, on tensors of
    ``device`` (CUDA tensors are staged through host memory by gloo)."""
    if device == "cuda":
        torch.cuda.set_device(0)
    mesh = lmesh.make_test_mesh((2, 2), ("data", "model"))
    x = rank_input(rank).to(device)
    coll.reset_stats()
    out = {
        "coords": (coll.axis_index(mesh, "data"),
                   coll.axis_index(mesh, "model")),
        "ppermute_swap": coll.ppermute(x, mesh, "model", [(0, 1), (1, 0)]),
        "ppermute_one": coll.ppermute(x, mesh, "data", [(0, 1)]),
        "ppermute_bool": coll.ppermute(x > 103, mesh, "model", [(1, 0)]),
        "psum_model": coll.psum(x, mesh, "model"),
        "psum_both": coll.psum(x, mesh, ("data", "model")),
        "psum_int": coll.psum(x.to(torch.int32), mesh, "data"),
        "psum_bf16": coll.psum(x.to(torch.bfloat16), mesh, "model").float(),
        "pmean_data": coll.pmean(x, mesh, "data"),
        "all_to_all": coll.all_to_all(x.reshape(2, 2, 2), mesh, "model"),
        "all_gather0": coll.all_gather(x, mesh, "data", 0),
        "all_gather1": coll.all_gather(x, mesh, "model", 1),
        "psum_scatter0": coll.psum_scatter(x, mesh, "model", 0),
        "psum_scatter1": coll.psum_scatter(x, mesh, "data", 1),
    }
    out = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
           for k, v in out.items()}
    out["stats"] = dict(coll.stats)
    return out


def fail_rank(rank, world):
    """Rank 1 raises; the others wait in a collective."""
    mesh = lmesh.make_test_mesh((world,), ("data",))
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    coll.psum(torch.ones(2), mesh, "data")


def hang_rank(rank, world):
    """Rank 0 never joins the collective the others wait in."""
    import time

    mesh = lmesh.make_test_mesh((world,), ("data",))
    if rank == 0:
        time.sleep(600)
    coll.psum(torch.ones(2), mesh, "data")


def chain_rank(rank, world, refs_path):
    """Every batch of the reference stream through chain_commit_spmd,
    one replica this rank, the plain commit."""
    z = np.load(refs_path)
    mesh = lmesh.make_test_mesh((world,), ("data",))
    cfg = tx.TxConfig(*(int(v) for v in z["chain/cfg"]))
    rep = tx.make_replica(cfg, "cpu")
    acks, deferred = [], []
    for b, m in zip(z["chain/batches"], z["chain/masks"]):
        rep, ack, dfr = tx.chain_commit_spmd(
            rep, torch.from_numpy(b), cfg, mesh, "data",
            torch.from_numpy(m), kernel_backend="ref")
        acks.append(ack.numpy())
        deferred.append(dfr.numpy())
    return interop.to_numpy(rep), acks, deferred


def cuda_chain_rank(rank, world, batches, masks):
    """chain_commit_spmd on the card (``auto``: the ``commit`` kernel) at
    a small shape, then the same batches through chain_commit_local on a
    whole chain: this rank's replica, decisions and launches."""
    from repro_torch.kernels import tx_commit as tc

    torch.cuda.set_device(0)
    mesh = lmesh.make_test_mesh((world,), ("data",))
    cfg = tx.TxConfig(num_keys=256, val_words=4, max_ops=3, chain_len=world,
                      log_capacity=64)
    rep = tx.make_replica(cfg, "cuda")
    chain = tx.make_chain(cfg, "cuda")
    tc.reset_launches()
    same = True
    for b, m in zip(batches, masks):
        b, m = torch.from_numpy(b).cuda(), torch.from_numpy(m).cuda()
        rep, ack, dfr = tx.chain_commit_spmd(rep, b, cfg, mesh, "data", m,
                                             kernel_backend="auto")
        chain, p, d = tx.chain_commit_local(chain, b, cfg, m,
                                            kernel_backend="auto")
        same &= torch.equal(d, dfr) and (
            torch.equal(p, ack) if rank == 0 else not bool(ack.any()))
    torch.cuda.synchronize()
    same &= all(torch.equal(getattr(rep, f), getattr(chain, f)[rank])
                for f in tx.ReplicaState._fields)
    return bool(same), dict(tc.launches), int(rep.committed)


def moe_config(cf: float):
    return reduced(get_config("qwen3-moe-30b-a3b")).replace(
        dtype="float32", num_experts=8, num_experts_per_tok=2, d_model=16,
        d_ff=8, capacity_factor=cf)


MOE_SPECS = {
    "ep": {"router": P(), "w_gate": P("model", None, None),
           "w_in": P("model", None, None), "w_out": P("model", None, None)},
    "tp": {"router": P(), "w_gate": P(None, None, "model"),
           "w_in": P(None, None, "model"), "w_out": P(None, "model", None)},
}


def moe_rank(rank, world, refs_path, kind, cf):
    """The EP or TP shard_map dispatch on a (2, 4) mesh, from this rank's
    blocks of the reference params and input."""
    z = np.load(refs_path)
    mesh = lmesh.make_test_mesh((2, 4), ("data", "model"))
    ctx = ParallelContext(mesh=mesh, use_ep=kind == "ep")
    pre = f"moe/cf{cf}/"
    params = {k: shard_block(torch.from_numpy(z[pre + "params/" + k]), sp,
                             mesh).contiguous()
              for k, sp in MOE_SPECS[kind].items()}
    x = shard_block(torch.from_numpy(z[pre + "x"]), P("data", None, None),
                    mesh)
    fn = moe_mod.moe_apply_ep_shardmap if kind == "ep" \
        else moe_mod.moe_apply_tp_shardmap
    y, aux = fn(params, x, moe_config(cf), ctx)
    return mesh.coord("data"), mesh.coord("model"), y.numpy(), float(aux)


def pipeline_config():
    return reduced(get_config("deepseek-7b")).replace(
        dtype="float32", num_layers=4, num_heads=2, num_kv_heads=2,
        head_dim=8, d_model=16, remat=False)


def pipeline_rank(rank, world, refs_path):
    """pipeline_apply on a (2, 2, 2) ("pod", "data", "model") mesh."""
    z = np.load(refs_path)
    mesh = lmesh.make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    ctx = ParallelContext(mesh=mesh, pod_axis="pod")
    layers = {}
    for key in z.files:
        if key.startswith("pp/layers/"):
            parts = key[len("pp/layers/"):].split("/")
            node = layers
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            full = torch.from_numpy(z[key])
            node[parts[-1]] = shard_block(
                full, P("pod", *([None] * (full.dim() - 1))), mesh).clone()
    x = shard_block(torch.from_numpy(z["pp/x"]), P("data", None, None), mesh)
    pos = torch.arange(x.shape[1], dtype=torch.int32)[None, :]
    y = pipeline_apply(layers, x, pipeline_config(), ctx, pos,
                       microbatches=2, chunk=8)
    return mesh.coord("pod"), mesh.coord("data"), y.numpy()


def restore_rank(rank, world, ckpt_dir):
    """JAX's 4-device checkpoint restored onto a 2-rank ("model",) mesh
    with P(None, "model"): by the checkpointer and by elastic.resume."""
    mesh = lmesh.make_test_mesh((world,), ("model",))
    like = {"w": torch.empty((8, 4), dtype=torch.float32, device="meta")}
    sh = {"w": NamedSharding(mesh, P(None, "model"))}
    out, step = checkpointer.restore(ckpt_dir, 1, like, sh, device="cpu")
    ctx = ParallelContext(mesh=mesh)
    res, step2 = elastic.resume(ckpt_dir, like, ctx,
                                specs={"w": P(None, "model")}, device="cpu")
    return mesh.coord("model"), out["w"].numpy(), step, res["w"].numpy(), \
        step2


def zero1_config():
    return reduced(get_config("qwen1.5-0.5b")).replace(dtype="float32")


def zero1_rank(rank, world, inputs_path, compress):
    """The ZeRO-1 step of ``launch.train.build_train_step`` on a (2, 1)
    ("data", "model") mesh, every step of the reference stream; with the
    whole moments gathered at the end (what a checkpoint stores) and the
    compression residuals' blocks (None without compression)."""
    z = np.load(inputs_path)
    cfg = zero1_config()
    mesh = lmesh.make_test_mesh((world, 1), ("data", "model"))
    ctx = lmesh.make_context(mesh, cfg)
    params = interop.lm_params_from_numpy(_unflat(z, "params/"), "cpu")
    ocfg = AdamWConfig()
    opt = zero1_init(params, ocfg, ctx)
    err = gc.init_error(opt.m) if compress else None
    step = ltrain.build_train_step(cfg, ctx, ocfg, compress=compress, chunk=8)
    metrics = []
    for tokens in z["tokens"]:
        batch = {"tokens": torch.from_numpy(tokens),
                 "labels": torch.from_numpy(np.roll(tokens, -1, axis=1))}
        params, opt, err, m = step(params, opt, err, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = zero1_gather(opt, params, ctx)
    return (interop.to_numpy(params), interop.to_numpy(opt.m),
            interop.to_numpy(opt.v), interop.to_numpy(whole.m), metrics,
            int(opt.step), None if err is None else interop.to_numpy(err))


def _unflat(z, prefix):
    tree: dict = {}
    for key in z.files:
        if key.startswith(prefix):
            parts = key[len(prefix):].split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree
