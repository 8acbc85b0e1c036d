"""ORCA-TX (§IV-B): chain-replicated multi-op transactions with
accelerator-side concurrency control.

HyperLoop (the paper's baseline) replicates each key-value *operation* as its
own group-RDMA message down the chain, so a (r, w)-op transaction costs
``(r + w)`` chain traversals. ORCA packs the whole transaction into ONE log
entry — ``[n_ops | (offset, value) * max_ops]`` with the count in the first
word, exactly the §IV-B log format — and the accelerator executes the
transaction near-data, so the chain is traversed once per transaction.

Concurrency control (paper: "any single key-value pair can only be accessed
by one outstanding transaction; the others are buffered in order"): within a
batch, a transaction proceeds iff it is the lowest-indexed claimant of every
offset it writes; the rest are deferred back to the client queue (retry).

Execution follows the plan/commit split of ``kvstore.plan_put``:
:func:`plan_commit` runs the ALU half ONCE per batch (parse, concurrency
control, intra-tx write dedupe, log-slot ranking) and emits a flat
:class:`TxCommitPlan`; the commit — the write-ahead log append + store
scatter — goes through ``kernels.ops``, which dispatches between the CUDA
kernels (``kernels/csrc/tx_commit.cu``) and their plain PyTorch versions
by the ``kernel_backend`` knob (``auto | cuda | ref``); both agree bit for
bit. The chain is a leading tensor axis, committed with ONE batched dual
scatter over the replicas (:func:`chain_commit_apply`), or one replica a
rank of a mesh axis (:func:`chain_commit_spmd`: the batch and the head's
decision pass hop by hop down the chain, each rank commits with
``commit``, the ACK passes back).

Mutation: a commit writes ``log`` and ``store`` IN PLACE (the counterpart
of the TPU kernels' ``input_output_aliases``; the plain versions do the
same), so the state passed to :func:`replica_commit`,
:func:`chain_commit_apply` or :func:`chain_commit_local` is updated. The
counters come back as new tensors.

Durability: the redo-log ring + ``log_tail`` are the durable truth —
every store write is logged first, so the store is derivable by
:func:`replay_records` from any consistent (store, log_tail) base plus the
log records past it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.parallel import collectives as coll

I32 = torch.int32


class TxConfig(NamedTuple):
    num_keys: int = 4096  # offset-addressed NVM region (rows)
    val_words: int = 4
    max_ops: int = 8  # max (read,write) ops per transaction
    chain_len: int = 2  # replicas
    log_capacity: int = 1024


class ReplicaState(NamedTuple):
    """Sentinel-resident layout: ``store`` and ``log`` each carry one
    permanent all-zero pad row past the live extent. Dead commit targets
    scatter zeroed payloads there, so no commit copies the O(state) arrays.
    ``live_store``/``live_log`` view the live rows (chain states with a
    leading replica axis included)."""

    store: torch.Tensor  # (NK + 1, VW) int32 — the NVM region; row NK = sentinel
    log: torch.Tensor  # (LC + 1, 1 + max_ops*(1+VW)) int32; row LC = sentinel
    log_tail: torch.Tensor  # () int32
    committed: torch.Tensor  # () int32
    # Chain-shortening liveness mask: () bool per replica, (R,) on a chain.
    # A dead replica is skipped by the commit walks with fixed shapes — its
    # log/store scatters retarget the sentinel row and its counters freeze.
    live: torch.Tensor

    @property
    def num_keys(self) -> int:
        """Live store rows (the resident sentinel row excluded)."""
        return self.store.shape[-2] - 1

    @property
    def log_capacity(self) -> int:
        """Live redo-log ring slots (the resident sentinel row excluded)."""
        return self.log.shape[-2] - 1

    @property
    def live_store(self) -> torch.Tensor:
        return self.store[..., :-1, :]

    @property
    def live_log(self) -> torch.Tensor:
        return self.log[..., :-1, :]


def tx_words(cfg: TxConfig) -> int:
    """[n_write_ops | (offset, value)*max_ops] — §IV-B log entry layout."""
    return 1 + cfg.max_ops * (1 + cfg.val_words)


def make_replica(cfg: TxConfig, device="cuda") -> ReplicaState:
    z = lambda: torch.zeros((), dtype=I32, device=device)  # noqa: E731
    return ReplicaState(
        store=torch.zeros((cfg.num_keys + 1, cfg.val_words), dtype=I32,
                          device=device),
        log=torch.zeros((cfg.log_capacity + 1, tx_words(cfg)), dtype=I32,
                        device=device),
        log_tail=z(),
        committed=z(),
        live=torch.ones((), dtype=torch.bool, device=device),
    )


def make_chain(cfg: TxConfig, device="cuda") -> ReplicaState:
    """Chain as a leading axis; every replica starts live. Each replica
    owns its memory: the commits write in place, so a stride-0 broadcast
    view would make every replica one buffer."""
    one = make_replica(cfg, device)
    return ReplicaState(*(
        x.expand((cfg.chain_len,) + tuple(x.shape)).clone() for x in one
    ))


def parse_tx(batch, cfg: TxConfig):
    """batch: (B, tx_words) -> (n_ops (B,), offsets (B,M), values (B,M,VW))."""
    b = batch.shape[0]
    n = torch.clamp(batch[:, 0], 0, cfg.max_ops)
    rest = batch[:, 1:].reshape(b, cfg.max_ops, 1 + cfg.val_words)
    offsets = torch.clamp(rest[..., 0], 0, cfg.num_keys - 1)
    values = rest[..., 1:].contiguous()
    return n, offsets, values


def concurrency_control(n_ops, offsets, cfg: TxConfig, mask=None):
    """First-claimant-wins conflict detection.

    Returns proceed (B,) — tx i proceeds iff for every live op offset, the
    minimum batch index claiming that offset is i (reads are free: the chain
    already serializes them, §IV-B). The owner table has one entry per key:
    O(num_keys) work per batch, as in the JAX package."""
    b, m = offsets.shape
    dev = offsets.device
    live = torch.arange(m, device=dev)[None, :] < n_ops[:, None]  # (B, M)
    if mask is not None:
        live = live & mask[:, None]
    idx = torch.arange(b, dtype=I32, device=dev)[:, None]
    claim_off = torch.where(live, offsets, cfg.num_keys)
    owner = torch.full((cfg.num_keys + 1,), b, dtype=I32, device=dev)
    owner.scatter_reduce_(0, claim_off.reshape(-1).to(torch.int64),
                          idx.expand(b, m).reshape(-1), "amin")
    mine = owner[claim_off] == idx
    ok = torch.all(mine | ~live, dim=1)
    if mask is not None:
        ok = ok & mask
    return ok


class TxCommitPlan(NamedTuple):
    """The ALU half of a transaction batch, computed ONCE per batch (not
    once per replica): everything a replica commit needs except its own
    ``log_tail``. ``store_rows == num_keys`` means no store write; a
    non-proceeding transaction's log slot resolves to ``log_capacity``
    inside the commit (both backends write zeros there)."""

    batch: torch.Tensor  # (B, TW) raw log records (what the ring persists)
    values: torch.Tensor  # (B, M, VW) parsed op values
    store_rows: torch.Tensor  # (B*M,) target store row per op, NK = dead
    log_rank: torch.Tensor  # (B,) rank among proceeding txs (log-slot offset)
    proceed: torch.Tensor  # (B,) bool — the live mask
    n_commit: torch.Tensor  # () int32 — log_tail / committed bump


def plan_commit(batch, cfg: TxConfig, mask=None, proceed=None) -> TxCommitPlan:
    """Plan a transaction batch without touching any replica: parse,
    first-claimant concurrency control, intra-tx write dedupe, log-slot
    ranking.

    ``proceed`` overrides concurrency control when the decision was made
    elsewhere (log replay forces it True).

    Within one transaction, duplicate write offsets resolve
    last-writer-wins (serial op order, §IV-B); shadowed ops get the drop
    sentinel. Combined with concurrency control keeping proceeding
    transactions' write sets disjoint, every live store row is unique —
    which is what lets the commit be a conflict-free dual scatter."""
    batch = batch.contiguous()
    b = batch.shape[0]
    m = cfg.max_ops
    n, off, val = parse_tx(batch, cfg)
    if proceed is None:
        proceed = concurrency_control(n, off, cfg, mask)
    j = torch.arange(m, device=batch.device)
    live = (j[None, :] < n[:, None]) & proceed[:, None]  # (B, M)
    # intra-tx dedupe: op j writes iff no later live op in the same tx
    # targets the same offset (last-writer-wins = serial op order)
    shadowed = torch.any(
        (off[:, :, None] == off[:, None, :])
        & live[:, None, :]
        & (j[None, None, :] > j[None, :, None]),
        dim=-1,
    )
    write = live & ~shadowed
    store_rows = torch.where(write, off, cfg.num_keys).reshape(b * m).to(I32)
    proceed_i = proceed.to(I32)
    log_rank = torch.cumsum(proceed_i, 0, dtype=I32) - 1
    return TxCommitPlan(
        batch, val, store_rows, log_rank, proceed, proceed_i.sum(dtype=I32),
    )


def commit_targets(state: ReplicaState, plan: TxCommitPlan):
    """Where a plan's writes land: (slot, store_rows) on one replica
    ((B,), (B*M,)) or on every replica of a chain ((R, B), (R, B*M)),
    from each replica's own ``log_tail`` and ``live`` flag.

    A batch committing more than LC transactions laps the ring within one
    scatter: two ranks share a slot iff they differ by a multiple of LC,
    so keeping only the last LC ranks IS sequential append order — and
    keeps every live slot unique for the parallel scatter. A dead replica
    (chain shortening) commits nothing: every slot aims at the sentinel
    and every store row is masked."""
    lc = state.log_capacity
    survives = plan.log_rank >= plan.n_commit - lc
    live = state.live[..., None]
    slot = torch.where(
        plan.proceed & survives & live,
        (state.log_tail[..., None] + plan.log_rank) % lc, lc,
    ).to(I32)
    store_rows = torch.where(live, plan.store_rows, state.num_keys).to(I32)
    return slot, store_rows


def _bumped(state: ReplicaState, plan: TxCommitPlan, log, store):
    """The state after a commit: the counters of live replicas advance by
    the plan's commits, dead ones freeze."""
    bump = torch.where(state.live, plan.n_commit, 0).to(I32)
    return ReplicaState(
        store, log, state.log_tail + bump, state.committed + bump,
        state.live,
    )


def replica_commit(state: ReplicaState, plan: TxCommitPlan, *,
                   kernel_backend: Optional[str] = "ref") -> ReplicaState:
    """Execute the planned memory half on one replica: redo-log append +
    store scatter (write-ahead ordering), fused in ``ops.tx_commit``, IN
    PLACE. Defaults to the plain version, as the JAX package does."""
    slot, store_rows = commit_targets(state, plan)
    log, store = kops.tx_commit(
        state.log, state.store, plan.batch, plan.values, slot, store_rows,
        backend=kernel_backend,
    )
    return _bumped(state, plan, log, store)


def replay_records(state: ReplicaState, records, cfg: TxConfig, *,
                   kernel_backend: Optional[str] = "ref") -> ReplicaState:
    """Replay raw redo-log records (in log order) into one replica through
    the normal plan/commit path — the WAL-replay loop of replica→replica
    resync and disk→engine recovery. ``proceed`` is forced True per
    record: the log only ever holds transactions that proceeded, so
    re-planning re-derives the very store scatter, log slot and counter
    bumps of the original commit — one record at a time, so the source's
    store and log ring come back bit for bit. The records must be
    consecutive from ``state.log_tail``."""
    dev = state.store.device
    for record in records:
        plan = plan_commit(
            torch.as_tensor(record, dtype=I32).to(dev)[None, :], cfg,
            proceed=torch.ones((1,), dtype=torch.bool, device=dev),
        )
        state = replica_commit(state, plan, kernel_backend=kernel_backend)
    return state


# ---------------------------------------------------------------------------
# Local (batched-over-replicas) chain
# ---------------------------------------------------------------------------

def chain_commit_apply(chain: ReplicaState, plan: TxCommitPlan, *,
                       kernel_backend: Optional[str] = "ref") -> ReplicaState:
    """Apply a precomputed plan to every replica of a local chain with ONE
    batched dual scatter over the replica axis (``ops.tx_commit_chain``),
    IN PLACE. Per-replica ``log_tail`` values are honoured, so a chain
    with skewed tails commits exactly like a :func:`replica_commit` loop.
    Dead replicas (``chain.live`` False) are skipped with fixed shapes:
    their log slots retarget the sentinel row and their ``log_tail``/
    ``committed`` freeze."""
    slot, store_rows = commit_targets(chain, plan)
    log, store = kops.tx_commit_chain(
        chain.log, chain.store, plan.batch, plan.values, slot, store_rows,
        backend=kernel_backend,
    )
    return _bumped(chain, plan, log, store)


def chain_commit_local(chain: ReplicaState, batch, cfg: TxConfig, mask=None,
                       *, kernel_backend: Optional[str] = "auto"):
    """Commit a batch through the whole chain. Returns (chain, committed,
    deferred). ``committed[i]`` True once every replica applied tx i.

    The plan is computed once; the commit is one whole-chain dual scatter
    (:func:`chain_commit_apply`), dispatched per ``kernel_backend``
    (default ``auto``: the CUDA kernel for CUDA tensors)."""
    plan = plan_commit(batch, cfg, mask)
    new_chain = chain_commit_apply(chain, plan, kernel_backend=kernel_backend)
    proceed = plan.proceed
    deferred = (mask if mask is not None else torch.ones_like(proceed)) \
        & ~proceed
    return new_chain, proceed, deferred


def chain_commit_spmd(replica: ReplicaState, batch, cfg: TxConfig, mesh,
                      axis: str = "data", mask=None,
                      *, kernel_backend: Optional[str] = "auto"):
    """One replica a rank along ``axis`` of a running mesh (its size is
    ``chain_len``); every rank calls this with its own replica. The head
    (coordinate 0) runs concurrency control on ``batch``; the batch and
    its ``proceed`` pass down the chain one hop at a time
    (``ppermute``); every rank commits the forwarded plan with
    :func:`replica_commit` (``commit``, one launch, for CUDA tensors
    under ``auto``); the ACK passes back ``chain_len - 1`` hops.

    Returns (this rank's replica, ack, deferred), as the JAX package's
    ``shard_map`` blocks: ``ack`` is the tail's ``proceed`` on the head
    and zeros elsewhere (a ppermute leaves zeros where nothing arrives),
    ``deferred`` is ``mask & ~proceed``. The replica is committed IN
    PLACE. Only the head's ``batch`` and ``mask`` are read for the
    decision; the other ranks' give the shapes (and their ``mask`` their
    ``deferred``)."""
    r = cfg.chain_len
    if mesh.shape[axis] != r:
        raise ValueError(f"axis {axis!r} has {mesh.shape[axis]} ranks, "
                         f"the chain {r} replicas")
    if mask is None:
        mask = torch.ones((batch.shape[0],), dtype=torch.bool,
                          device=batch.device)
    me = coll.axis_index(mesh, axis)
    if me == 0:
        n, off, _ = parse_tx(batch, cfg)
        proceed = concurrency_control(n, off, cfg, mask)
    else:
        proceed = torch.zeros_like(mask)
    for i in range(r - 1):  # hop i: rank i -> rank i + 1
        b_nxt = coll.ppermute(batch, mesh, axis, [(i, i + 1)])
        p_nxt = coll.ppermute(proceed, mesh, axis, [(i, i + 1)])
        if me == i + 1:
            batch, proceed = b_nxt, p_nxt
    plan = plan_commit(batch, cfg, proceed=proceed)
    new_rep = replica_commit(replica, plan, kernel_backend=kernel_backend)
    ack = proceed
    for i in range(r - 1):  # tail -> head
        j = r - 1 - i
        ack = coll.ppermute(ack, mesh, axis, [(j, j - 1)])
    return new_rep, ack, mask & ~proceed


def chain_hops(cfg: TxConfig, n_ops: int, per_op: bool) -> int:
    """Chain traversals (forward + ACK) per transaction: the latency model
    behind Fig. 11. HyperLoop: one traversal per op; ORCA: one per tx."""
    traversals = n_ops if per_op else 1
    return traversals * 2 * (cfg.chain_len - 1)
