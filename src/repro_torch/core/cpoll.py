"""C2 — cpoll: coherence-assisted notification via a pointer buffer.

Paper §III-B: instead of spin-polling every request ring, the accelerator
monitors one small contiguous region — one 4-byte monotonically
increasing counter per ring (the pointer buffer) — and a ring tracker on
the consumer recovers the number of new requests even when notifications
coalesce, because ring tails only ever increment. The engine step
compares the pointer buffer against its tracker: an O(4·Q)-byte scan with
no per-ring traffic. ``bytes_scanned_*`` quantify the Fig. 7 claim.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core._drop import add_drop

I32 = torch.int32


class CpollState(NamedTuple):
    pointer_buffer: torch.Tensor  # (Q,) int32, producer-side doorbell counters
    ring_tracker: torch.Tensor  # (Q,) int32, consumer-side recorded counters


def make(num_queues: int, device="cuda") -> CpollState:
    z = torch.zeros((num_queues,), dtype=I32, device=device)
    return CpollState(z, z.clone())


def doorbell(state: CpollState, queue_ids, counts) -> CpollState:
    """Producer side: bump pointer-buffer entries after writing requests.
    Multiple doorbells to the same queue may be rung in one batch (the
    RDMA batched-doorbell optimisation) — they coalesce, by design."""
    pb = add_drop(state.pointer_buffer, (queue_ids,), counts.to(I32))
    return CpollState(pb, state.ring_tracker)


def cpoll(state: CpollState):
    """Consumer side: one vectorised compare of the 4B/queue region.

    Returns (new_counts (Q,), acknowledged state). Wrap-safe: int32
    subtraction of monotonic counters. Coalescing-safe: the tracker diff
    counts *entries*, not *signals* (paper's ring-tracker argument).
    """
    new = state.pointer_buffer - state.ring_tracker
    acked = CpollState(state.pointer_buffer, state.pointer_buffer)
    return new, acked


def cpoll_partial(state: CpollState, queue_ids, counts) -> CpollState:
    """Acknowledge only ``counts`` entries of the given queues (used when the
    scheduler takes fewer requests than arrived)."""
    rt = add_drop(state.ring_tracker, (queue_ids,), counts.to(I32))
    return CpollState(state.pointer_buffer, rt)


def bytes_scanned_cpoll(num_queues: int) -> int:
    """Bytes the consumer touches per notification scan with cpoll."""
    return 4 * num_queues


def bytes_scanned_polling(num_queues: int, capacity: int, entry_words: int) -> int:
    """Bytes touched per scan when spin-polling every ring slot header: one
    64 B line per ring at best (the head entry), against cpoll's 4 B."""
    return num_queues * max(64, 4 * entry_words)
