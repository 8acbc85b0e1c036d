"""The SPMD collectives over one named mesh axis, and a rank launcher:
the port's twin of the JAX package's ``repro/compat.py::shard_map`` and
the ``jax.lax`` collectives its callers use inside it.

JAX writes a per-device function and ``shard_map`` runs it on every
device of a mesh. Here the per-rank function runs in one process a rank
(:func:`launch`), and the collectives below are ``torch.distributed``
calls on the process group of one axis of a running
``sharding.Mesh``. Each has JAX's semantics:

- :func:`axis_index` — this rank's coordinate along the axis;
- :func:`ppermute` — ``(src, dst)`` pairs of axis coordinates, by
  ``batch_isend_irecv``; a rank no pair sends to gets zeros;
- :func:`psum`, :func:`pmean` — over one axis or several; :func:`pmax`;
- :func:`all_to_all` — split and concatenate on dim 0, ``tiled=False``;
- :func:`all_gather` — ``tiled=True`` on a dim; :func:`psum_scatter`, its
  reverse (reduce-scatter, ``tiled=True``), for the ZeRO-1 update;
- :func:`model_psum`, :func:`model_copy`, :func:`model_reduce`,
  :func:`model_gather`, :func:`model_block` — Megatron's forms over a
  ``ParallelContext``'s model axis (the identity at tp 1);
- :func:`data_psum`, :func:`data_pmean`, :func:`data_gather`,
  :func:`data_rank` — the same context's batch axes (the identity at
  dp 1).

Gradients. ``psum``/``pmean``, ``all_gather``, ``psum_scatter`` and
``all_to_all`` of a tensor that needs a gradient run as
``torch.autograd.Function``s over the same transport, under one
invariant: a tensor that every rank of the axis holds whole carries its
whole gradient on every rank. So a sum's backward is the identity, a
gather's takes this rank's block, a reduce-scatter's is an all-gather,
an all-to-all's is the reverse all-to-all; :func:`model_copy` (identity
forward, a sum backward) marks the input of every product whose weight
the model axis splits, and :func:`model_block`'s backward is an
all-gather. :func:`pmax` takes no gradient. The data axes take the
other rule: the data ranks hold different losses (each its rows'), so
:func:`data_psum`'s backward sums the ranks' cotangents. Every rank
issues the backward's collectives in the same order (one program, one
graph), so a recomputation under ``torch.utils.checkpoint`` reissues the
forward's at the same point on every rank.

Transport. The caller names the backend when it launches the ranks, and
nothing picks or falls back to another. Ranks with a card each use
``nccl``, which moves CUDA tensors. Ranks that share one card (NCCL
refuses two ranks on one device) use ``gloo``: a CUDA tensor goes through
a page-locked host buffer, explicitly, in both directions, so a hop is
host time (loopback TCP), not NVLink. CPU tensors go to gloo as they are.
On an axis of size 1 every collective is the identity and needs no
process group.

``stats`` counts the collective calls of this process and the bytes it
handed them (the payload each call's input holds: what this rank puts on
the wire, before the backend's own algorithm).
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

stats = {"calls": 0, "bytes": 0}

BACKENDS = ("gloo", "nccl")
INIT_TIMEOUT = 60.0  # s, the rendezvous of a launch's ranks


def reset_stats() -> None:
    stats["calls"] = 0
    stats["bytes"] = 0


def _count(x: torch.Tensor) -> None:
    stats["calls"] += 1
    stats["bytes"] += x.numel() * x.element_size()


# ---------------------------------------------------------------------------
# Transport: host staging for CUDA tensors on gloo
# ---------------------------------------------------------------------------

def _staged(group, x: torch.Tensor) -> bool:
    """True when ``x`` must cross through host memory: a CUDA tensor on a
    gloo group. A CPU tensor on an nccl group is refused."""
    backend = dist.get_backend(group)
    if backend == "gloo":
        return x.is_cuda
    if not x.is_cuda:
        raise ValueError(f"a CPU tensor on a {backend} group")
    return False


def _wire(x: torch.Tensor, staged: bool) -> torch.Tensor:
    """The tensor the backend reads: a contiguous page-locked host copy
    of a staged CUDA tensor (gloo has no bool: bytes instead)."""
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    if staged:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return h.copy_(x)  # synchronous: done when it returns
    return x.contiguous()


def _empty_wire(shape, like: torch.Tensor, staged: bool) -> torch.Tensor:
    dt = torch.uint8 if like.dtype == torch.bool else like.dtype
    if staged:
        return torch.empty(shape, dtype=dt, pin_memory=True)
    return torch.empty(shape, dtype=dt, device=like.device)


def _back(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The result on ``like``'s device and dtype."""
    out = w.to(like.device)
    return out.view(torch.bool) if like.dtype == torch.bool else out


def _size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


# ---------------------------------------------------------------------------
# Collectives over one named axis
# ---------------------------------------------------------------------------

def axis_index(mesh, axis: str) -> int:
    """``jax.lax.axis_index``: this rank's coordinate along ``axis``."""
    return mesh.coord(axis)


def ppermute(x: torch.Tensor, mesh, axis: str,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: each ``(src, dst)`` pair of ``axis``
    coordinates sends src's ``x`` to dst; a rank that no pair sends to
    gets zeros."""
    me = mesh.coord(axis)
    sends = [d for s, d in perm if s == me]
    recvs = [s for s, d in perm if d == me]
    if mesh.shape[axis] == 1:
        return x.clone() if recvs else torch.zeros_like(x)
    group = mesh.group(axis)
    staged = _staged(group, x)
    ops, out = [], None
    for d in sends:
        w = _wire(x, staged)
        _count(w)
        ops.append(dist.P2POp(dist.isend, w,
                              dist.get_global_rank(group, d), group))
    for s in recvs:
        out = _empty_wire(x.shape, x, staged)
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, s), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if out is None:
        return torch.zeros_like(x)
    return _back(out, x)


def _all_reduce(x: torch.Tensor, mesh, axis: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    if mesh.shape[axis] == 1:
        return x.clone()
    group = mesh.group(axis)
    staged = _staged(group, x)
    w = _wire(x, staged)
    if not staged:
        w = w.clone()
    _count(w)
    dist.all_reduce(w, op=op, group=group)
    return _back(w, x)


def _grad(x: torch.Tensor) -> bool:
    """True when autograd records an operation on ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


class _Sum(torch.autograd.Function):
    """A sum over axes whose result every rank holds whole: the partials'
    gradient is the result's (identity backward)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``jax.lax.psum`` over one axis or a tuple of them (one all-reduce
    an axis, in order). Every rank gets the same bits. Under autograd the
    backward is the identity (the module's invariant)."""
    if _grad(x):
        return _Sum.apply(x, mesh, _axes(axis))
    for a in _axes(axis):
        x = _all_reduce(x, mesh, a)
    return x


def pmax(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``jax.lax.pmax`` over one axis or a tuple of them; no gradient
    flows through it (a log-sum-exp's max cancels out)."""
    x = x.detach()
    for a in _axes(axis):
        x = _all_reduce(x, mesh, a, dist.ReduceOp.MAX)
    return x


def pmean(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``jax.lax.pmean``: :func:`psum` over the axes' size."""
    return psum(x, mesh, axis) / _size(mesh, _axes(axis))


class _AllToAll(torch.autograd.Function):
    """Its own transpose: the gradient goes back by the reverse
    all-to-all."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.mesh, ctx.axis), None, None


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=False)``: ``x`` is (n, ...) for an axis of n ranks; block j goes
    to rank j, and block i of the result came from rank i. Under autograd
    the backward is the reverse all-to-all."""
    if _grad(x):
        return _AllToAll.apply(x, mesh, axis)
    n = mesh.shape[axis]
    if x.shape[0] != n:
        raise ValueError(f"all_to_all: dim 0 is {x.shape[0]}, axis {n}")
    if n == 1:
        return x.clone()
    group = mesh.group(axis)
    staged = _staged(group, x)
    w = _wire(x, staged)
    out = _empty_wire(x.shape, x, staged)
    _count(w)
    dist.all_to_all_single(out, w, group=group)
    return _back(out, x)


def _own_block(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor split over ``axis``."""
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axis} ({n})")
    k = x.shape[dim] // n
    return x.narrow(dim, mesh.coord(axis) * k, k)


class _Gather(torch.autograd.Function):
    """A gather whose result every rank holds whole: this rank's block of
    the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_own_block(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(),
                None, None, None)


class _Block(torch.autograd.Function):
    """This rank's block of a tensor every rank holds whole: the ranks'
    gradient blocks gathered."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own_block(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """A reduce-scatter of partials: each partial's gradient is the
    gathered gradient of the blocks."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return psum_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: the ranks'
    blocks concatenated along ``dim`` in axis order. Under autograd the
    backward takes this rank's block."""
    if _grad(x):
        return _Gather.apply(x, mesh, axis, dim)
    n = mesh.shape[axis]
    if n == 1:
        return x.clone()
    group = mesh.group(axis)
    staged = _staged(group, x)
    w = _wire(x.movedim(dim, 0), staged)
    out = _empty_wire((n * w.shape[0],) + tuple(w.shape[1:]), x, staged)
    _count(w)
    dist.all_gather_into_tensor(out, w, group=group)
    return _back(out, x).movedim(0, dim)


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim,
    tiled=True)``: the sum over the axis, of which this rank keeps block
    ``axis_index`` along ``dim``. Under autograd the backward is an
    all-gather."""
    if _grad(x):
        return _ReduceScatter.apply(x, mesh, axis, dim)
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    if n == 1:
        return x.clone()
    group = mesh.group(axis)
    staged = _staged(group, x)
    w = _wire(x.movedim(dim, 0), staged)
    out = _empty_wire((w.shape[0] // n,) + tuple(w.shape[1:]), x, staged)
    _count(w)
    dist.reduce_scatter_tensor(out, w, group=group)
    return _back(out, x).movedim(0, dim)


# ---------------------------------------------------------------------------
# Megatron tensor parallelism over a context's model axis
# ---------------------------------------------------------------------------
# The forms the model needs, on ``ctx.model_axis`` of a running
# ``ctx.mesh`` (a ``sharding.ParallelContext``). Each is the identity (or
# the whole tensor) when ``ctx`` splits nothing: no mesh, or a model axis
# of one rank. Their gradients keep the module's invariant: a tensor
# every model rank holds whole carries its whole gradient on every rank.

def tensor_parallel(ctx) -> bool:
    """True when ``ctx`` splits the model over more than one rank."""
    return ctx is not None and ctx.mesh is not None and ctx.tp > 1


def model_rank(ctx) -> int:
    """This rank's coordinate along the model axis (0 without a mesh)."""
    return 0 if ctx is None or ctx.mesh is None else \
        ctx.mesh.coord(ctx.model_axis)


def model_psum(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum over the model axis of a row-split product's partials;
    backward the identity."""
    if not tensor_parallel(ctx):
        return x
    return psum(x, ctx.mesh, ctx.model_axis)


class _Copy(torch.autograd.Function):
    """Megatron's *f*: identity forward, a sum over the axis backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axis), None, None


def model_copy(x: torch.Tensor, ctx) -> torch.Tensor:
    """``x``, which every model rank holds whole, as the input of
    rank-local work: a product whose weight the model axis splits, or a
    replicated parameter applied to this rank's block of the sequence.
    Forward the identity; backward the sum over the model axis of the
    ranks' partial gradients (Megatron's *f*)."""
    if not (tensor_parallel(ctx) and _grad(x)):
        return x
    return _Copy.apply(x, ctx.mesh, ctx.model_axis)


# The data axes. A statistic each data rank computes from its own rows
# (the MoE router's load-balance means) is averaged over a context's
# batch axes, and every rank then holds the whole batch's value. Unlike
# the model axis, the data ranks hold DIFFERENT losses: the ZeRO-1 step
# weights each rank's by its share of the tokens and sums the ranks'
# gradients. So the whole gradient of such a statistic is the sum of the
# ranks' cotangents, not any one rank's: the backward of
# :func:`data_psum` is a sum over the data axes, where the model axis's
# sum (:func:`psum`, :func:`model_psum`) takes the identity.

def data_parallel(ctx) -> bool:
    """True when ``ctx`` splits the batch over more than one rank."""
    return ctx is not None and ctx.mesh is not None and ctx.dp > 1


def data_rank(ctx) -> int:
    """This rank's index over ``ctx``'s batch axes (major to minor, the
    order ``sharding.batch_spec`` gives the rows in); 0 without a
    mesh."""
    if ctx is None or ctx.mesh is None:
        return 0
    r = 0
    for a in ctx.batch_axes:
        r = r * ctx.mesh.shape[a] + ctx.mesh.coord(a)
    return r


class _DataSum(torch.autograd.Function):
    """A sum over the data axes whose backward sums the ranks' cotangents
    over the same axes (the data ranks' losses differ)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axes), None, None


def data_psum(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum of ``x`` over ``ctx``'s batch axes (the identity at one
    data rank). Backward: the sum over the same axes of the ranks'
    cotangents."""
    if not data_parallel(ctx):
        return x
    if _grad(x):
        return _DataSum.apply(x, ctx.mesh, tuple(ctx.batch_axes))
    return psum(x, ctx.mesh, ctx.batch_axes)


def data_pmean(x: torch.Tensor, ctx) -> torch.Tensor:
    """:func:`data_psum` over the number of data ranks: the whole batch's
    mean of a per-rank mean over equal row counts."""
    return data_psum(x, ctx) / ctx.dp if data_parallel(ctx) else x


def data_gather(x: torch.Tensor, ctx, dim: int = 0) -> torch.Tensor:
    """The data ranks' blocks concatenated along ``dim`` in
    :func:`data_rank` order (the identity at one data rank); no
    gradient."""
    if not data_parallel(ctx):
        return x
    x = x.detach()
    for a in reversed(ctx.batch_axes):  # the minor axis first
        x = all_gather(x, ctx.mesh, a, dim)
    return x


def model_reduce(x: torch.Tensor, ctx, seq_dim=None) -> torch.Tensor:
    """A row-split product's partials summed over the model axis: whole
    (:func:`model_psum`), or with ``seq_dim`` this rank's block of the
    sum along the sequence (Megatron sequence parallelism's
    reduce-scatter, :func:`psum_scatter`; backward an all-gather)."""
    if seq_dim is None or not tensor_parallel(ctx):
        return model_psum(x, ctx)
    return psum_scatter(x, ctx.mesh, ctx.model_axis, seq_dim)


def model_gather(x: torch.Tensor, ctx, dim: int) -> torch.Tensor:
    """The model ranks' blocks concatenated along ``dim``: a sequence-
    sharded activation made whole, or the vocab shards of the logits.
    Backward takes this rank's block."""
    if not tensor_parallel(ctx):
        return x
    return all_gather(x, ctx.mesh, ctx.model_axis, dim)


def model_block(x: torch.Tensor, ctx, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of a tensor every model rank holds
    whole: no communication forward; backward the ranks' gradient blocks
    gathered."""
    if not tensor_parallel(ctx):
        return x
    if _grad(x):
        return _Block.apply(x, ctx.mesh, ctx.model_axis, dim)
    return _own_block(x, ctx.mesh, ctx.model_axis, dim)


# ---------------------------------------------------------------------------
# The rank launcher
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world: int, backend: str, store_path: str,
               args: tuple, results, op_timeout: float,
               num_threads: Optional[int]) -> None:
    try:
        if num_threads:
            torch.set_num_threads(num_threads)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        # the store's own wait bounds the rendezvous; the group's timeout
        # bounds every collective after it
        store.set_timeout(datetime.timedelta(seconds=INIT_TIMEOUT))
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=op_timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 -- carried to the caller
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, world: int, *, backend: str, args: tuple = (),
           timeout: float = 120.0, num_threads: Optional[int] = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, each
    a rank of a ``torch.distributed`` group of ``backend`` (``gloo`` or
    ``nccl``; the caller names it), rendezvous through a ``FileStore`` in
    a new temporary directory (no TCP port to race for). Returns the
    ranks' return values, in rank order (they cross by pickling: return
    numpy arrays or plain data, not tensors: the queue passes a tensor's
    storage by a file descriptor that dies with its rank).

    ``INIT_TIMEOUT`` bounds the rendezvous, ``timeout`` the whole run
    (and each collective). A rank's exception is raised here with its
    traceback; on any failure or timeout every rank still running is
    killed, so none is left hanging. ``fn`` must be importable by name
    (a module-level function): the ``spawn`` start method pickles it."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(fn, r, world, backend, os.path.join(tmp, "store"), args,
              results, timeout, num_threads))
        for r in range(world)]
    deadline = time.monotonic() + timeout + INIT_TIMEOUT
    got: dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world)) - set(got))} of "
                    f"{world} did not finish in "
                    f"{timeout + INIT_TIMEOUT:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # a rank may have put its result just before exiting
                    try:
                        rank, ok, out = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world)]
