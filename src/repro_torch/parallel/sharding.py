"""Sharding rules: the head-padding plan, parameter partition specs,
parallel contexts — the JAX package's ``repro/parallel/sharding.py``.

The production mesh is ``(16, 16)`` with axes ``("data", "model")`` per
pod and ``(2, 16, 16)`` with ``("pod", "data", "model")`` across pods.
:func:`head_plan` pads query heads within kv groups and pads/replicates kv
heads so that every (H, KV) maps onto the model axis with its GQA
grouping kept; padded query heads are masked to zero at the attention
output. At ``tp = 1`` the plan is the identity layout.

The spec functions are pure: a :class:`Mesh` answers ``.shape[axis]``
with no process group, as JAX's ``AbstractMesh`` does, so the partition
rules run (and are held against JAX's) on any mesh shape. A running mesh
(``launch.mesh.make_test_mesh`` after ``torch.distributed`` is up) also
carries one process group per named axis and this rank's coordinates;
the collectives (``parallel.collectives``) run over those groups.

Programs here are per rank (SPMD by hand, as inside JAX's ``shard_map``):
a tensor a rank holds is its block of the logical array.
:class:`PartitionSpec` names which mesh axes split each dimension, and
:func:`shard_block` cuts a rank's block out of a full array (an elastic
restore, the ZeRO-1 moments, a rank's rows of the global batch), and
:func:`param_blocks` a rank's block of a whole params tree (Megatron
tensor parallelism over the ``model`` axis).
:func:`shard` — JAX's sharding constraint — changes no value, and is the
identity here.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.tree import tree_map

# ---------------------------------------------------------------------------
# Head plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HeadPlan:
    """Physical attention layout for a given tensor-parallel degree."""

    h: int  # logical query heads
    kv: int  # logical kv heads
    tp: int  # model-axis size
    hp: int  # padded query heads (divisible by tp)
    kvp: int  # padded kv heads
    repl: int  # kv replication factor
    gp: int  # padded q heads per kv group

    @property
    def kv_phys(self) -> int:
        """Stored kv heads (after replication)."""
        return self.kvp * self.repl

    @property
    def group(self) -> int:
        """Logical q heads per kv head."""
        return max(1, math.ceil(self.h / max(self.kv, 1)))

    def q_to_kv(self, padded_q_head: int) -> int:
        """Logical kv head feeding a padded q head index."""
        return (padded_q_head // self.gp) % max(self.kvp, 1)


def head_plan(h: int, kv: int, tp: int) -> HeadPlan:
    if h == 0:
        return HeadPlan(0, 0, tp, 0, 0, 1, 0)
    g = math.ceil(h / kv)
    if kv % tp == 0:
        return HeadPlan(h, kv, tp, kv * g, kv, 1, g)
    if kv < tp:
        # pad kv up to the smallest divisor of tp that is >= kv, then
        # replicate to fill the axis
        kvp = next(p for p in range(kv, tp + 1) if tp % p == 0)
        repl = tp // kvp
        gp = math.ceil(g / repl) * repl
    else:
        kvp = math.ceil(kv / tp) * tp
        repl = 1
        gp = g
    hp = kvp * gp
    assert hp % tp == 0
    return HeadPlan(h, kv, tp, hp, kvp, repl, gp)


# ---------------------------------------------------------------------------
# Mesh and PartitionSpec
# ---------------------------------------------------------------------------

class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry a dimension, ``None`` (whole) or
    a mesh axis name or a tuple of them (major to minor). It IS the tuple
    of its entries, so it compares equal to ``tuple(jax_spec)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """Named axes over ranks, row-major (the last axis varies fastest).

    ``shape`` maps each axis name to its size, as JAX's mesh does. A mesh
    built with ``groups`` (one ``torch.distributed`` process group an
    axis) and ``rank`` is running: :meth:`coord` is this rank's index
    along an axis. Without them it is abstract, and rank 0's."""

    def __init__(self, shape, axis_names, *, rank: int = 0,
                 groups: Optional[dict] = None, backend: Optional[str] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.groups = dict(groups or {})
        self.backend = backend

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        stride = 1
        for name in reversed(self.axis_names):
            if name == axis:
                return (self.rank // stride) % self.shape[name]
            stride *= self.shape[name]
        raise KeyError(axis)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if axis not in self.groups:
            raise RuntimeError(
                f"mesh axis {axis!r} has no process group: the mesh is "
                "abstract (build a running one with launch.mesh)")
        return self.groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}"
                f"{', ' + self.backend if self.backend else ''})")


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry (None -> ())."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_block(x, spec, mesh: Optional[Mesh]):
    """This rank's block of the full array ``x`` under ``spec``: each
    dimension split over its entry's axes (major to minor) takes the slice
    at this rank's coordinates. A dimension must divide evenly."""
    if mesh is None:
        return x
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coord(a)
            n *= mesh.shape[a]
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n})")
        k = x.shape[d] // n
        x = x.narrow(d, idx * k, k)
    return x


@dataclass(frozen=True)
class NamedSharding:
    """JAX's ``NamedSharding``: a spec on a mesh. :meth:`block` is what a
    rank of the mesh holds of a full array."""

    mesh: Mesh
    spec: PartitionSpec

    def block(self, x):
        return shard_block(x, self.spec, self.mesh)


# ---------------------------------------------------------------------------
# Parallel context
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelContext:
    """Everything model code needs to know about the mesh (or its
    absence)."""

    mesh: Optional[Mesh] = None
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    pod_axis: Optional[str] = None
    fsdp: bool = False  # shard params over data_axes[-1] as well
    use_ep: bool = False  # MoE expert parallelism over the model axis
    ep_shardmap: bool = False  # EP via explicit all-to-all
    sp: bool = False  # Megatron sequence sharding for norm regions
    pp_stages: int = 1  # pipeline stages over the pod axis

    def _replace(self, **kw) -> "ParallelContext":
        return dataclasses.replace(self, **kw)

    @property
    def tp(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.shape[self.model_axis]

    @property
    def dp(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in self.batch_axes)

    @property
    def batch_axes(self) -> tuple[str, ...]:
        if self.pod_axis and self.pp_stages == 1:
            return (self.pod_axis,) + self.data_axes
        return self.data_axes

    @property
    def fsdp_axis(self) -> Optional[str]:
        return self.data_axes[-1] if self.fsdp else None

    def axis(self, *names: Optional[str]) -> PartitionSpec:
        """A PartitionSpec, dropping the axes when there is no mesh."""
        if self.mesh is None:
            return P()
        return P(*names)


def local_context() -> ParallelContext:
    """Single-device context."""
    return ParallelContext(mesh=None)


# ---------------------------------------------------------------------------
# Partition rules (path-pattern based, t5x style)
# ---------------------------------------------------------------------------

def _match(path: str, *frags: str) -> bool:
    return all(f in path for f in frags)


def spec_for_param(path: str, ndim: int, ctx: ParallelContext) -> PartitionSpec:
    """PartitionSpec for a parameter identified by its tree path.

    TP follows Megatron: QKV/O on (padded) heads, MLP on d_ff, embedding
    and LM head on vocab. ``fsdp`` also shards the other big dim over the
    data axis. MoE 'ep' shards the expert dim on model; MoE 'tp' shards
    expert d_ff on model."""
    if ctx.mesh is None:
        return P()
    m, f = ctx.model_axis, ctx.fsdp_axis
    lead = [None] * (ndim - 2)
    if _match(path, "embed"):  # (V, D) or (K, V, D)
        return P(*lead, m, f)
    if _match(path, "lm_head"):  # (D, V) or (K, D, V)
        return P(*lead, f, m)
    if _match(path, "moe", "router"):
        return P(*([None] * ndim))
    if _match(path, "moe", "w_out"):  # (E, F, D)
        return P(m, None, f) if ctx.use_ep else P(None, m, f)
    if _match(path, "moe"):  # w_in / w_gate: (E, D, F)
        return P(m, f, None) if ctx.use_ep else P(None, f, m)
    if any(_match(path, "attn", w) for w in ("wq", "wk", "wv")):
        if ndim == 3:  # (D, heads, head_dim)
            return P(f, m, None)
        return P(m, None)
    if any(_match(path, "attn", b) for b in ("bq", "bk", "bv")):
        return P(m, None)  # (heads, head_dim)
    if _match(path, "attn", "wo"):  # (heads, head_dim, D)
        return P(m, None, f)
    if _match(path, "mlp", "w_out"):  # (F, D)
        return P(m, f)
    if _match(path, "mlp"):  # w_in / w_gate: (D, F)
        return P(f, m)
    if _match(path, "tmix", "w_out"):  # (H, hd, D)
        return P(m, None, f)
    if _match(path, "tmix") and ndim == 3:  # (D, H, hd) projections
        return P(f, m, None)
    if _match(path, "cmix", "w_out"):
        return P(m, f)
    if _match(path, "cmix") and ndim == 2:
        return P(f, m)
    # the Mamba branch (hymba: 50 heads do not divide the model axis) and
    # everything else (norms, scalars, small vectors) replicated
    return P(*([None] * ndim))


def _spec_tree(node, path: str, ctx: ParallelContext):
    if isinstance(node, dict):
        return {k: _spec_tree(v, f"{path}/{k}" if path else str(k), ctx)
                for k, v in node.items()}
    ndim = len(node.shape)
    if path.startswith("layers/") or "/layers/" in path:
        # L-stacked: the per-layer spec behind a leading None
        base = spec_for_param(path, ndim - 1, ctx)
        return P(None, *base) if ctx.mesh is not None else P()
    return spec_for_param(path, ndim, ctx)


def param_specs(params_tree: Any, ctx: ParallelContext) -> Any:
    """The spec of every leaf of a params tree (tensors, meta tensors or
    anything with ``.shape``), paths joined with ``/`` as JAX's are."""
    return _spec_tree(params_tree, "", ctx)


def param_blocks(params: Any, ctx: ParallelContext) -> Any:
    """This rank's block of every leaf of a full params tree, by
    :func:`param_specs` and :func:`shard_block`, each a copy of its own
    (so the full tree can be freed). Under Megatron tensor parallelism a
    rank holds its heads of ``wq``/``wk``/``wv``/``wo``, its ``d_ff``
    block of the MLP, its vocab rows of the embedding and columns of the
    head, and its experts (``use_ep``) or their ``d_ff`` block. Without a
    split (no mesh, model axis 1, no fsdp) the tree itself."""
    if ctx.mesh is None or (ctx.tp == 1 and not ctx.fsdp):
        return params
    return tree_map(lambda x, spec: shard_block(x, spec, ctx.mesh).clone(
        memory_format=torch.contiguous_format), params,
        param_specs(params, ctx))


def shard(x, ctx: ParallelContext, *axes):
    """JAX's sharding constraint: it changes no value, and a rank already
    holds its block, so it is the identity."""
    return x


def batch_spec(ctx: ParallelContext, *rest) -> PartitionSpec:
    """Spec with the leading dim sharded over all batch axes."""
    if ctx.mesh is None:
        return P()
    axes = ctx.batch_axes
    lead = axes[0] if len(axes) == 1 else axes
    return P(lead, *rest)

