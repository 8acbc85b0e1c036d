"""C3 (scheduler part) — round-robin request scheduling over queues.

The paper's cc-accelerator scheduler fetches cpoll signals and feeds the APU
round-robin (§V). This is the vectorised equivalent: a fair water-fill of
the step budget over queues with pending work, with a rotating priority
pointer so ties break in round-robin order across steps, plus per-queue
weights.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import status as st

I32 = torch.int32


class SchedState(NamedTuple):
    rr_ptr: torch.Tensor  # () int32 rotating priority pointer
    served: torch.Tensor  # (Q,) total served per queue (stats/fairness)


def make(num_queues: int, device="cuda") -> SchedState:
    return SchedState(torch.zeros((), dtype=I32, device=device),
                      torch.zeros((num_queues,), dtype=I32, device=device))


def schedule(state: SchedState, avail, budget: int, weights=None):
    """Pick how many requests to take per queue this step.

    avail: (Q,) pending counts (from cpoll). budget: static max batch.
    weights: (Q,) relative service weights (default uniform).

    Returns (take (Q,), new_state). Guarantees sum(take) <= budget,
    take <= avail, and round-robin rotation of leftover assignment.

    The water-fill runs in float32, as the JAX package's does; for the
    default uniform weights every quantity is an exact integer, so the
    two agree bit for bit. Non-uniform weights would also need the JAX
    summation order pinned.
    """
    q = avail.shape[0]
    dev = avail.device
    if weights is None:
        weights = torch.ones((q,), dtype=torch.float32, device=dev)
    avail = torch.clamp(avail, min=0)

    # water-fill: 8 rounds converge for any distribution because each
    # round either exhausts the budget or saturates a queue
    take = torch.zeros((q,), dtype=I32, device=dev)
    left = torch.tensor(budget, dtype=I32, device=dev)
    for _ in range(8):
        want = avail - take
        active = want > 0
        w = torch.where(active, weights, 0.0)
        wsum = torch.clamp(torch.sum(w), min=1e-9)
        share = torch.floor(left * w / wsum).to(I32)
        share = torch.minimum(share, want)
        # when budget < active queues, floor() gives 0 — fall through to rr
        take = take + share
        left = left - torch.sum(share).to(I32)

    # distribute the remainder one-by-one in round-robin order from rr_ptr
    order = (torch.arange(q, dtype=I32, device=dev) + state.rr_ptr) % q
    want = (avail - take)[order] > 0
    grant_rank = torch.cumsum(want.to(I32), 0).to(I32) - 1
    extra = (want & (grant_rank < left)).to(I32)
    take = take.index_add(0, order, extra)

    new = SchedState((state.rr_ptr + 1) % q, state.served + take)
    return take, new


def shed_plan(deadlines, valid, now, quota: int):
    """Deadline-based load shedding: which queue-head entries to give up on
    BEFORE spending batch budget.

    deadlines: (Q, K) absolute engine-step deadlines of the first K entries
    per queue (<= 0 = no deadline, never shed). valid: (Q, K) entry-exists
    mask. now: () current engine step. quota: static per-queue service
    rate estimate (requests/step) used to predict the earliest step an
    entry at queue position ``pos`` can be served: ``now + pos // quota``.
    An entry is *doomed* when its deadline is not after that step.

    Only the doomed *prefix* of each queue is shed (FIFO pop semantics).
    Returns ``(counts (Q,), shed (Q, K) prefix mask, status (Q, K))`` where
    status distinguishes already-expired entries (TIMEOUT) from predictive
    sheds (SHED).
    """
    k = deadlines.shape[1]
    pos = torch.arange(k, dtype=I32, device=deadlines.device)
    has_deadline = valid & (deadlines > 0)
    expired = has_deadline & (now >= deadlines)
    doomed = has_deadline & (now + pos[None, :] // max(quota, 1) >= deadlines)
    prefix = torch.cumprod(doomed.to(I32), dim=1).to(torch.bool)
    counts = torch.sum(prefix.to(I32), dim=1).to(I32)
    status = torch.where(
        expired, torch.tensor(st.TIMEOUT, dtype=I32, device=deadlines.device),
        torch.tensor(st.SHED, dtype=I32, device=deadlines.device),
    )
    return counts, prefix, status


def selected_queues(take):
    """Compact (queue_ids, counts) ordering for gather_batch: all queues,
    zero-count ones included (static shapes; gather_batch masks them)."""
    q = take.shape[0]
    return torch.arange(q, dtype=I32, device=take.device), take
