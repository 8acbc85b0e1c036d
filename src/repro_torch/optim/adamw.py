"""AdamW over trees of tensors, the JAX package's optimizer
(``repro/optim/adamw.py``): global-norm clipping, bias-corrected moments
kept in ``state_dtype`` (f32 by default, bf16 to halve them), weight
decay on the leaves of two or more dimensions only, every update in f32.
(``torch.optim.AdamW`` is another function: no global clip, decay on
every leaf, moments in the parameter's dtype.)

ZeRO-1: :func:`zero1_spec` shards the biggest replicated dim of each
moment over the data axis, as JAX's state specs do, and
:func:`zero1_update` is the step that JAX's GSPMD makes of those specs,
written out per rank: reduce-scatter each gradient along that dim (a
leaf with none is all-reduced and updated whole on every rank), clip by
the global norm (the squares of the blocks all-reduced), update this
rank's block of the parameter and its moments, all-gather the
parameter. Every rank ends with the same parameter bits.

Under Megatron tensor parallelism (a model axis of more than one rank)
each rank holds its model blocks of the parameters and gradients
(``sharding.param_specs``): :func:`zero1_update`'s global norm sums the
squares of the split leaves over the model axis and counts the
replicated ones once (the padded global arrays' norm, kv replicas
included), and a ZeRO-1 moment is the data-axis block of the rank's
model block (the whole block at one data rank)."""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models.layers import dtype_of
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (
    P, ParallelContext, PartitionSpec, param_specs, shard_block, spec_axes,
)
from repro_torch.tree import leaves, tree_map, unzip

F32 = torch.float32


class AdamWConfig(NamedTuple):
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor  # () int32: updates applied


def init(params, cfg: AdamWConfig) -> OptState:
    """Zero moments in ``cfg.state_dtype``, step 0, on the params'
    device."""
    dt = dtype_of(cfg.state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    dev = leaves(params)[0].device
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def model_split(tree, ctx: Optional[ParallelContext]):
    """Each leaf of a params-shaped tree: True where the model axis splits
    it (a rank holds a block), by ``sharding.param_specs``; all False
    without tensor parallelism."""
    if not coll.tensor_parallel(ctx):
        return tree_map(lambda _: False, tree)
    return tree_map(
        lambda sp: any(ctx.model_axis in spec_axes(e) for e in sp),
        param_specs(tree, ctx))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares (f32), leaves in order."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def _leaf_update(p, g, m, v, scale, c1, c2, lr, cfg: AdamWConfig, dt):
    """One leaf's AdamW step in f32: (new p, new m, new v)."""
    g = g.float() * scale
    m1 = cfg.b1 * m.float() + (1 - cfg.b1) * g
    v1 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
    u = (m1 / c1) / (torch.sqrt(v1 / c2) + cfg.eps)
    if p.dim() >= 2:
        u = u + cfg.weight_decay * p.float()
    new_p = p.float() - lr * u
    return new_p.to(p.dtype), m1.to(dt), v1.to(dt)


def _clip_scale(gnorm, cfg: AdamWConfig):
    return torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)


def update(grads, state: OptState, params, lr, cfg: AdamWConfig, *,
           gnorm=None):
    """One AdamW step. ``lr`` is a float or an f32 scalar tensor. Returns
    (new params, new state, {"grad_norm"}); nothing is written in place.
    ``gnorm`` (an f32 scalar tensor) replaces :func:`global_norm` of
    ``grads`` for the clip: a reference that replays a data-parallel
    step passes the ranks' norm, whose sum runs in another order."""
    step = state.step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg)
    dt = dtype_of(cfg.state_dtype)
    c1 = 1 - cfg.b1 ** step.float()
    c2 = 1 - cfg.b2 ** step.float()
    out = tree_map(lambda p, g, m, v: _leaf_update(
        p, g, m, v, scale, c1, c2, lr, cfg, dt), params, grads, state.m,
        state.v)
    new_p, new_m, new_v = unzip(out, 3)
    return new_p, OptState(new_m, new_v, step), {"grad_norm": gnorm}


# ---------------------------------------------------------------------------
# ZeRO-1: moments sharded over the data axis
# ---------------------------------------------------------------------------

def zero1_spec(pspec: PartitionSpec, shape, ctx: ParallelContext
               ) -> PartitionSpec:
    """Shard the biggest replicated dim of an optimizer-state leaf over
    the data axis (ZeRO-1). Already-fsdp'd params keep their spec."""
    if ctx.mesh is None:
        return P()
    axis = ctx.data_axes[-1]
    if any(axis in spec_axes(e) for e in pspec) or not shape:
        return pspec
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    size = ctx.mesh.shape[axis]
    best, best_dim = -1, -1
    for d, (s, e) in enumerate(zip(shape, entries)):
        if e is None and s % size == 0 and s > best:
            best, best_dim = s, d
    if best_dim < 0:
        return pspec
    entries[best_dim] = axis
    return P(*entries)


def state_specs(param_specs, params_abs, ctx: ParallelContext) -> OptState:
    mv = tree_map(lambda sp, p: zero1_spec(sp, tuple(p.shape), ctx),
                  param_specs, params_abs)
    return OptState(m=mv, v=mv, step=P())


def zero1_dims(params, ctx: ParallelContext):
    """Each leaf's ZeRO-1 dimension (None: the leaf stays whole), from
    :func:`zero1_spec` of its parameter spec. ``params`` are this rank's
    model blocks (the whole leaves at tp 1): a model-split dimension is
    never the data axis's, and the others keep their global sizes, so the
    dims are those of JAX's ``state_specs``. fsdp is not ported."""
    if ctx.mesh is not None and ctx.fsdp:
        raise NotImplementedError("ZeRO-1 with fsdp parameter blocks is "
                                  "not ported")
    axis = ctx.data_axes[-1]

    def dim_of(sp, p):
        z = zero1_spec(sp, tuple(p.shape), ctx)
        return next((d for d, e in enumerate(z) if axis in spec_axes(e)),
                    None)

    return tree_map(dim_of, param_specs(params, ctx), params)


def _block(x, dim, ctx: ParallelContext):
    if dim is None:
        return x
    spec = [None] * x.dim()
    spec[dim] = ctx.data_axes[-1]
    return shard_block(x, P(*spec), ctx.mesh)


def zero1_init(params, cfg: AdamWConfig, ctx: ParallelContext) -> OptState:
    """Zero moments, each this rank's block (the whole leaf where it has
    no ZeRO-1 dim)."""
    dims = zero1_dims(params, ctx)
    full = init(params, cfg)
    blk = lambda t, d: _block(t, d, ctx).clone()  # noqa: E731
    return OptState(tree_map(blk, full.m, dims), tree_map(blk, full.v, dims),
                    full.step)


def zero1_update(grads, state: OptState, params, lr, cfg: AdamWConfig,
                 ctx: ParallelContext, *, err=None, compress=None):
    """One ZeRO-1 AdamW step on this rank. ``grads`` are this rank's
    gradients, already weighted so that their sum over the data axis is
    the global batch's gradient; ``state`` holds this rank's moment
    blocks. ``compress`` (``parallel.compress.roundtrip``) is applied to
    the reduced gradient blocks with their residuals ``err`` (blocks, as
    the moments), each block against its whole leaf's scale, so the
    payloads and updates are those of one device compressing the whole
    gradient. Returns (params, state, err, {"grad_norm"}): the params
    whole (this rank's model blocks under tensor parallelism) and equal
    on every rank of the data axis."""
    mesh, axis = ctx.mesh, ctx.data_axes[-1]
    tp = coll.tensor_parallel(ctx)
    dims = zero1_dims(params, ctx)
    red = tree_map(
        lambda g, d: coll.psum(g.float(), mesh, axis) if d is None
        else coll.psum_scatter(g.float(), mesh, axis, d), grads, dims)
    if compress is not None:
        # one scale a logical leaf: the max over its blocks, data and
        # model (the whole leaves are equal on every rank, so their max is
        # their own)
        axes = (axis, ctx.model_axis) if tp else axis
        red, err = compress(red, err,
                            amax=lambda mx: coll.pmax(mx, mesh, axes))
    # the global squared norm: each leaf's squares summed over the axes
    # that split it (data: its ZeRO-1 dim; model: its spec), a whole
    # leaf's once (each rank holds it all)
    zero = torch.zeros((), dtype=F32, device=leaves(params)[0].device)
    sq = {(d, m): zero for d in (True, False) for m in (True, False)}
    for g, d, m in zip(leaves(red), leaves(dims),
                       leaves(model_split(params, ctx))):
        sq[d is not None, m] = sq[d is not None, m] + torch.sum(
            torch.square(g))
    by_model = torch.stack([sq[True, True], sq[False, True]])
    if tp:
        by_model = coll.psum(by_model, mesh, ctx.model_axis)
    by_data = coll.psum(torch.stack([sq[True, False], by_model[0]]), mesh,
                        axis)
    gnorm = torch.sqrt(by_data[0] + by_data[1] + by_model[1]
                       + sq[False, False])
    scale = _clip_scale(gnorm, cfg)
    step = state.step + 1
    dt = dtype_of(cfg.state_dtype)
    c1 = 1 - cfg.b1 ** step.float()
    c2 = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v, d):
        p1, m1, v1 = _leaf_update(_block(p, d, ctx), g, m, v, scale, c1, c2,
                                  lr, cfg, dt)
        if d is not None:
            p1 = coll.all_gather(p1, mesh, axis, d).contiguous()
        return p1, m1, v1

    out = tree_map(upd, params, red, state.m, state.v, dims)
    new_p, new_m, new_v = unzip(out, 3)
    return new_p, OptState(new_m, new_v, step), err, {"grad_norm": gnorm}


def zero1_gather(state: OptState, params, ctx: ParallelContext) -> OptState:
    """The whole moments (every rank's blocks all-gathered): what a
    checkpoint stores, the full logical arrays."""
    mesh, axis = ctx.mesh, ctx.data_axes[-1]
    dims = zero1_dims(params, ctx)
    whole = lambda t, d: t if d is None else \
        coll.all_gather(t, mesh, axis, d).contiguous()  # noqa: E731
    return OptState(tree_map(whole, state.m, dims),
                    tree_map(whole, state.v, dims), state.step)
