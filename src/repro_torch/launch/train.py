"""Training launcher: the fault-tolerant driver loop of the JAX package's
``repro/launch/train.py``, on one device; and the step under a mesh
(:func:`build_train_step`): ZeRO-1 over the data axis, Megatron tensor
parallelism over the model axis, or both.

It composes the substrates: the deterministic data pipeline, AdamW with
the warmup-cosine schedule, optional int8 error-feedback gradient
compression, async checkpointing with atomic commit, the straggler
watchdog, retry on transient errors, and resume from the latest committed
step on restart.

    PYTHONPATH=src python -m repro_torch.launch.train               # a GPU
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu

``--arch`` takes any config (or ``dense-100m``, the example driver's
~100M-parameter model); ``--reduced`` (the default) swaps in the tiny f32
config of its family so the loop runs in seconds, ``--full`` keeps the
config's widths, depth and dtype. ``--seq-len`` and ``--batch`` cut the
shape: by default to 64 x 8 when reduced, and not at all with
``--full``. The entry point runs on the card unless ``--device cpu`` is
given.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs import SHAPES, ModelConfig, get_config, reduced
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.fault import StragglerDetector, with_retries
from repro_torch.models import init_params, loss_fn, postprocess_grads
from repro_torch.optim import AdamWConfig, init as opt_init, \
    update as opt_update, warmup_cosine, zero1_update
from repro_torch.tree import leaves, tree_map
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import compress as gc
from repro_torch.parallel.sharding import batch_spec, local_context, \
    shard_block


def grads_of(params, batch, cfg, ctx, *, chunk: int = 512):
    """(loss, metrics, grads): ``loss_fn`` and its gradient with respect
    to every leaf of ``params`` (zeros for a leaf the loss does not
    reach)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = loss_fn(live, batch, cfg, ctx, chunk=chunk)
    flat = leaves(live)
    got = dict(zip(map(id, flat),
                   torch.autograd.grad(loss, flat, allow_unused=True)))
    grads = tree_map(lambda p: torch.zeros_like(p) if got[id(p)] is None
                     else got[id(p)], live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def local_batch(batch, ctx):
    """This rank's rows of a global batch (``batch_spec``: the leading
    dim over the batch axes)."""
    spec = batch_spec(ctx)
    return {k: shard_block(v, spec, ctx.mesh) for k, v in batch.items()}


def build_train_step(cfg, ctx, opt_cfg, *, compress: bool = False,
                     chunk: int = 512):
    """``step(params, opt, err, batch) -> (params, opt, err, metrics)``:
    the loss and its gradients at the schedule's learning rate of
    ``opt.step``, the kv-replica tie, the compression round trip when
    ``compress`` (``err`` the residuals, else None), and one AdamW update.
    Nothing is written in place: the caller's params and state stay
    valid.

    Under a context with a mesh, every rank calls the step with the same
    global batch and takes its rows of it (:func:`local_batch`); ``opt``
    (and ``err``, then ``compress.init_error(opt.m)``) hold this rank's
    ZeRO-1 blocks (``optim.zero1_init``: whole at one data rank) and the
    update is ``optim.zero1_update``. Each rank's gradient is weighted
    by its share of the batch's tokens, so the reduced gradient and the
    loss are the global batch's: the single-device step's. Under tensor
    parallelism (a model axis of more than one rank) ``params``, ``opt``
    and ``err`` are this rank's model blocks (``sharding.param_blocks``;
    the moments the data-axis blocks of them): the gradient comes back
    through the model-axis collectives' backward, the kv replicas are
    tied across ranks (``models.postprocess_grads``), the clip takes the
    global norm and the compression each whole leaf's scale. An MoE
    block over data ranks takes the JAX package's semantics of its
    dispatch: GSPMD ``moe_apply`` the whole batch's capacity, dispatch
    positions and router statistics, the ``shard_map`` dispatches each
    rank's capacity and the batch's statistics; the statistics' mean over
    the data axis sums the ranks' cotangents in its backward
    (``collectives.data_psum``), so the aux loss's gradient is the global
    batch's."""
    if ctx.mesh is not None:
        return _build_zero1_step(cfg, ctx, opt_cfg, compress=compress,
                                 chunk=chunk)

    def train_step(params, opt, err, batch):
        lr = warmup_cosine(opt.step)
        loss, metrics, grads = grads_of(params, batch, cfg, ctx, chunk=chunk)
        grads = postprocess_grads(grads, cfg, ctx)
        if compress:
            grads, err = gc.roundtrip(grads, err)
        params, opt, om = opt_update(grads, opt, params, lr, opt_cfg)
        return params, opt, err, {"loss": loss, "lr": lr, **metrics, **om}

    return train_step


def _build_zero1_step(cfg, ctx, opt_cfg, *, compress: bool, chunk: int):
    if len(ctx.batch_axes) != 1:
        raise NotImplementedError("ZeRO-1 reduces over one data axis")
    mesh, axes = ctx.mesh, ctx.batch_axes

    def train_step(params, opt, err, batch):
        lr = warmup_cosine(opt.step)
        local = local_batch(batch, ctx)
        share = local["labels"].numel() / batch["labels"].numel()
        loss, metrics, grads = grads_of(params, local, cfg, ctx, chunk=chunk)
        grads = postprocess_grads(grads, cfg, ctx)
        grads = tree_map(lambda g: g.float() * share, grads)
        params, opt, err, om = zero1_update(
            grads, opt, params, lr, opt_cfg, ctx, err=err,
            compress=gc.roundtrip if compress else None)
        loss = coll.psum(loss.float() * share, mesh, axes)
        metrics = {k: coll.psum(v.float() * share, mesh, axes)
                   for k, v in metrics.items()}
        return params, opt, err, {"loss": loss, "lr": lr, **metrics, **om}

    return train_step


DENSE_100M = ModelConfig(
    name="dense-100m", family="dense", num_layers=10, d_model=640,
    num_heads=10, num_kv_heads=10, d_ff=2560, vocab_size=32000,
    dtype="float32", remat=False,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.arch == "dense-100m":
        cfg = DENSE_100M
    else:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg).replace(dtype="float32")
    shape = SHAPES[args.shape]
    seq_len = args.seq_len or (64 if args.reduced else shape.seq_len)
    batch_n = args.batch or (8 if args.reduced else shape.global_batch)
    shape = dataclasses.replace(shape, seq_len=seq_len, global_batch=batch_n)
    ctx = local_context()
    device = torch.device(args.device)

    params = init_params(args.seed, cfg, ctx, device)
    opt_cfg = AdamWConfig()
    opt = opt_init(params, opt_cfg)
    err = gc.init_error(params) if args.compress_grads else None

    # resume: a restart picks up the last committed step
    start_step = 0
    last = latest_step(args.ckpt_dir)
    if last is not None:
        tree, start_step = restore(args.ckpt_dir, last,
                                   {"params": params, "opt": opt})
        params, opt = tree["params"], tree["opt"]
        print(f"[resume] restored step {start_step} from {args.ckpt_dir}")

    step_fn = build_train_step(cfg, ctx, opt_cfg,
                               compress=args.compress_grads, chunk=64)
    pipe = TokenPipeline(cfg, shape, DataConfig(seed=args.seed),
                         start_step=start_step)
    ckpt = AsyncCheckpointer(args.ckpt_dir)
    dog = StragglerDetector()

    try:
        for _ in range(args.steps):
            step, host_batch = next(pipe)
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in host_batch.items()}
            t0 = time.perf_counter()
            params, opt, err, metrics = with_retries(
                step_fn, params, opt, err, batch, retries=2)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            flag = dog.observe(dt)
            if flag["straggler"]:
                print(f"[watchdog] step {step}: {dt*1e3:.0f}ms > "
                      f"{dog.threshold}x EMA ({flag['ema']*1e3:.0f}ms)")
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f}ms")
            if args.ckpt_every and step and step % args.ckpt_every == 0:
                ckpt.save(step, {"params": params, "opt": opt})
        ckpt.save(step, {"params": params, "opt": opt})
        ckpt.wait()
        print(f"[done] {args.steps} steps; final loss {loss:.4f}; "
              f"checkpoint at step {step}")
    finally:
        pipe.close()
    return loss


if __name__ == "__main__":
    main()
