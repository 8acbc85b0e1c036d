"""The single-device part of the JAX package's sharding rules: the
head-padding plan, a parallel context at world size 1, and ``shard`` as
the identity.

:func:`head_plan` pads query heads within kv groups and pads/replicates kv
heads so that every (H, KV) maps onto a tensor-parallel degree ``tp`` with
its GQA grouping kept; padded query heads are masked to zero at the
attention output. At ``tp = 1`` the plan is the identity layout
(``hp = kv * ceil(h / kv)``, no replication).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


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


@dataclass(frozen=True)
class ParallelContext:
    """What model code needs to know about the devices: here, one."""

    world_size: int = 1

    @property
    def tp(self) -> int:
        return self.world_size


def local_context() -> ParallelContext:
    """Single-device context."""
    return ParallelContext()


def shard(x, ctx: ParallelContext, *axes):
    """A sharding constraint; the identity on one device."""
    return x
