"""Elastic scaling: restore any checkpoint onto any mesh — the JAX
package's ``repro/checkpoint/elastic.py``.

A checkpoint stores full logical arrays, so restoring onto a different
mesh gives each rank its block of every array by the specs of the NEW
mesh; the specs come from the same partition rules, which depend only on
(config, context), not on the mesh that saved. The data pipeline is
step-indexed (``data/pipeline.py``), so resuming at step N on K' ranks
consumes exactly the batches a K-rank run would have.
"""
from __future__ import annotations

from typing import Any

from repro_torch.checkpoint.checkpointer import latest_step, restore
from repro_torch.parallel.sharding import (
    NamedSharding, ParallelContext, PartitionSpec, param_specs,
)


def _map_specs(fn, specs):
    """``fn`` over the PartitionSpec leaves of dicts and NamedTuples (a
    spec is a tuple, so the checkpointer's walk would enter it)."""
    if isinstance(specs, PartitionSpec):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(_map_specs(fn, v) for v in specs))
    raise TypeError(f"not a spec tree node: {type(specs).__name__}")


def shardings_for(tree_abs: Any, ctx: ParallelContext, specs: Any = None):
    """A ``NamedSharding`` a leaf on ``ctx.mesh``: ``specs`` (a matching
    tree of PartitionSpecs, e.g. ``{"params": param_specs(...), "opt":
    optim.state_specs(...)}``), by default the params' ``param_specs``."""
    if ctx.mesh is None:
        return None
    if specs is None:
        specs = param_specs(tree_abs, ctx)
    return _map_specs(lambda sp: NamedSharding(ctx.mesh, sp), specs)


def resume(directory: str, params_abs: Any, ctx: ParallelContext, *,
           specs: Any = None, device: Any = "cuda"):
    """Returns (params, step) from the latest checkpoint, each leaf this
    rank's block on ``ctx.mesh`` (see :func:`shardings_for`), on
    ``device`` (the card unless the caller asks for the CPU); or
    (None, 0) when no checkpoint exists."""
    step = latest_step(directory)
    if step is None:
        return None, 0
    sh = shardings_for(params_abs, ctx, specs)
    return restore(directory, step, params_abs, sh, device=device)
