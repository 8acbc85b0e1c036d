"""C1 — unified inter/intra-machine communication: lock-free SPSC ring buffers.

The paper (§III-A) builds every communication path on per-connection
request/response ring-buffer pairs with credit-based flow control: the
producer only sends a request when ``tail - head < capacity``.

Here the rings are device-resident int32 tensors. Producers are hosts
(request injection between steps) or the device itself (response path);
the consumer is the engine step. Counters are monotonic int32 (wrap-safe
modular arithmetic); slot index = counter % capacity. Many queues are
stacked on the leading axis so one vectorised op serves all connections.
Every function returns new tensors: the state passed in is not modified.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core._drop import add_drop, set_drop

I32 = torch.int32


class RingState(NamedTuple):
    """``num_queues`` SPSC rings of ``capacity`` entries of ``entry_words``
    int32 words (HERD-style fixed-width RPC slots)."""

    entries: torch.Tensor  # (Q, C, W) int32
    tail: torch.Tensor  # (Q,) producer counter, monotonic
    head: torch.Tensor  # (Q,) consumer counter, monotonic

    @property
    def num_queues(self) -> int:
        return self.entries.shape[0]

    @property
    def capacity(self) -> int:
        return self.entries.shape[1]

    @property
    def entry_words(self) -> int:
        return self.entries.shape[2]


def make(num_queues: int, capacity: int, entry_words: int,
         device="cuda") -> RingState:
    return RingState(
        entries=torch.zeros((num_queues, capacity, entry_words), dtype=I32,
                            device=device),
        tail=torch.zeros((num_queues,), dtype=I32, device=device),
        head=torch.zeros((num_queues,), dtype=I32, device=device),
    )


def available(state: RingState) -> torch.Tensor:
    """(Q,) entries ready to consume (wrap-safe monotonic diff)."""
    return state.tail - state.head


def free_slots(state: RingState) -> torch.Tensor:
    """(Q,) credit left for the producer (paper's flow control)."""
    return state.capacity - (state.tail - state.head)


def rank_within(ids: torch.Tensor, num: int) -> torch.Tensor:
    """Stable rank of each element among equal ids; ids lie in [0, num)."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    first = torch.searchsorted(
        sorted_ids, torch.arange(num, dtype=ids.dtype, device=ids.device),
        side="left",
    )
    rank_sorted = torch.arange(n, device=ids.device) - first[sorted_ids]
    rank = torch.zeros((n,), dtype=I32, device=ids.device)
    rank[order] = rank_sorted.to(I32)
    return rank


def enqueue(state: RingState, queue_ids, payloads, mask=None):
    """Producer push. queue_ids: (N,), payloads: (N, W), mask: (N,) bool.

    Returns ``(state, accepted)``: ``accepted[i]`` is True iff entry i
    landed in its ring. An entry is rejected (ring untouched) when its
    queue has no credit left (:func:`free_slots` back-pressure). A call
    that repeats a masked-in queue id breaks the SPSC contract (one
    producer writes one slot per queue per call) and raises
    ``ValueError``: this is the host's injection path, so the check reads
    the device once.
    """
    n = queue_ids.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=queue_ids.device)
    nq = state.num_queues
    ids = torch.where(mask, queue_ids, nq)
    dup = mask & (rank_within(ids, nq + 1) > 0)
    if bool(dup.any()):
        raise ValueError(
            "ringbuf.enqueue: duplicate queue ids in one call violate the "
            "SPSC contract (one slot per queue per call); make separate "
            "calls per wave or use the engine response path"
        )
    credit = free_slots(state)[queue_ids] > 0
    ok = mask & credit
    slot = state.tail[queue_ids] % state.capacity
    q = torch.where(ok, queue_ids, nq)  # row nq: dropped
    entries = set_drop(state.entries, (q, slot), payloads)
    tail = add_drop(state.tail, (q,), ok.to(I32))
    return RingState(entries, tail, state.head), ok


def peek(state: RingState, queue_ids, offsets):
    """Read entry at head+offset for each (queue, offset) pair."""
    slot = (state.head[queue_ids] + offsets) % state.capacity
    return state.entries[queue_ids, slot]


def pop(state: RingState, queue_ids, counts) -> RingState:
    """Consumer advance: head[q] += counts (entries were already peeked).
    Also zeroes consumed slots — the paper's "reset to 0 on completion",
    which is what keeps the cpoll region owned by the consumer. The slots
    to clear are one (len(queue_ids), capacity) mask, so no loop bound is
    read back from the device."""
    cap = state.capacity
    nq = state.num_queues
    offs = torch.arange(cap, dtype=I32, device=counts.device)
    slot = (state.head[queue_ids][:, None] + offs[None, :]) % cap
    live = offs[None, :] < counts[:, None]
    qq = torch.where(live, queue_ids[:, None], nq)
    clear = torch.zeros((nq + 1, cap), dtype=torch.bool, device=counts.device)
    clear[qq, slot] = True
    entries = torch.where(clear[:nq, :, None], 0, state.entries)
    head = add_drop(state.head, (queue_ids,), counts.to(I32))
    return RingState(entries, state.tail, head)


def gather_batch(state: RingState, queue_ids, counts, budget: int):
    """Flatten per-queue head runs into one padded batch.

    Returns (payloads (budget, W), src_queue (budget,), valid (budget,)).
    Layout: queue-major in the order given (the scheduler's round-robin
    order), each queue contributing ``counts[i]`` consecutive entries.
    """
    nq = queue_ids.shape[0]
    counts = counts.to(I32)
    starts = (torch.cumsum(counts, 0) - counts).to(I32)  # (nq,)
    total = torch.sum(counts)
    pos = torch.arange(budget, dtype=I32, device=counts.device)
    # for each output slot, which queue-run does it fall into?
    run = torch.searchsorted(starts, pos, side="right") - 1
    run = torch.clamp(run, 0, nq - 1)
    offset = pos - starts[run]
    valid = pos < total
    q = queue_ids[run]
    payloads = peek(state, q, offset)
    payloads = torch.where(valid[:, None], payloads, 0)
    return payloads, torch.where(valid, q, -1).to(I32), valid


# ---------------------------------------------------------------------------
# Host-side client mirror — the "client machine" in tests and load programs.
# ---------------------------------------------------------------------------

class HostClient:
    """Client-side view of one connection: writes requests (one-sided-write
    analogue = feeding tensors into the next engine step), polls responses,
    and enforces credit-based flow control locally (paper §III-A)."""

    def __init__(self, queue_id: int, capacity: int, entry_words: int):
        self.queue_id = queue_id
        self.capacity = capacity
        self.entry_words = entry_words
        self.req_tail = 0  # local record of request-ring tail
        self.resp_head = 0  # local record of response-ring head

    def can_send(self, n: int = 1) -> bool:
        return (self.req_tail + n) - self.resp_head <= self.capacity

    def note_sent(self, n: int = 1) -> None:
        self.req_tail += n

    def note_received(self, n: int = 1) -> None:
        self.resp_head += n

    @property
    def in_flight(self) -> int:
        return self.req_tail - self.resp_head
