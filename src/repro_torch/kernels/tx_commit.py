"""Wrappers of the CUDA ORCA-TX commit kernels (``csrc/tx_commit.cu``).

The memory half of a planned transaction batch
(``core.transaction.plan_commit``): append each proceeding transaction's
log record to its ring slot AND scatter its planned store writes, in one
launch.

  ``commit``        one replica: log (LC + 1, TW), store (NK + 1, VW)
  ``commit_chain``  every replica of a local chain: (R, LC + 1, TW) and
                    (R, NK + 1, VW), per-replica log slots, store rows
                    shared or per replica

Both update the log and the store IN PLACE, like the TPU kernels'
``input_output_aliases``, and write zeros where a target is the sentinel
row (``slot == LC``, ``rows == NK``). The wrappers follow ``_launch``
(CUDA tensors only, checked, launched on the current stream);
``launches`` counts each kernel's launches since the last
:func:`reset_launches`.
"""
from __future__ import annotations

from repro_torch.kernels._launch import LL, I, P, Library, check, same

KERNELS = ("commit", "commit_chain")
_lib = Library("tx_commit", KERNELS, {
    "orca_tx_commit": [P] * 6 + [LL, I, I, I, LL, LL],
    "orca_tx_commit_chain": [P] * 6 + [LL, LL, I, I, I, LL, LL, LL],
})
launches = _lib.launches
reset_launches = _lib.reset


def _payload(batch, values, dev):
    check("batch", batch, 2, dev)
    check("values", values, 3, dev)
    b, tw = batch.shape
    _, m, vw = values.shape
    same("values", values.shape[:1], (b,))
    return b, tw, m, vw


def commit(log, store, batch, values, slot, rows):
    """One replica's commit, IN PLACE. log: (LC + 1, TW); store:
    (NK + 1, VW) — the sentinel-resident layout; batch: (B, TW); values:
    (B, M, VW); slot: (B,) log slots in [0, LC]; rows: (B*M,) store rows
    in [0, NK]. Live targets must be unique, as the plan makes them.
    Returns (log, store), the same tensors."""
    dev = batch.device
    b, tw, m, vw = _payload(batch, values, dev)
    check("log", log, 2, dev)
    same("log", log.shape[1:], (tw,))
    check("store", store, 2, dev)
    same("store", store.shape[1:], (vw,))
    check("slot", slot, 1, dev)
    same("slot", slot.shape, (b,))
    check("rows", rows, 1, dev)
    same("rows", rows.shape, (b * m,))
    _lib.launch("commit", "orca_tx_commit", dev, log.data_ptr(),
                store.data_ptr(), batch.data_ptr(), values.data_ptr(),
                slot.data_ptr(), rows.data_ptr(), b, m, tw, vw,
                log.shape[0] - 1, store.shape[0] - 1)
    return log, store


def commit_chain(log, store, batch, values, slot, rows):
    """Whole-chain commit, IN PLACE. log: (R, LC + 1, TW); store:
    (R, NK + 1, VW); batch: (B, TW) and values: (B, M, VW), shared by
    every replica; slot: (R, B); rows: (B*M,) shared by every replica or
    (R, B*M) per replica. Returns (log, store), the same tensors."""
    dev = batch.device
    b, tw, m, vw = _payload(batch, values, dev)
    check("log", log, 3, dev)
    r = log.shape[0]
    same("log", (r,) + tuple(log.shape[2:]), (r, tw))
    check("store", store, 3, dev)
    same("store", (store.shape[0],) + tuple(store.shape[2:]), (r, vw))
    check("slot", slot, 2, dev)
    same("slot", slot.shape, (r, b))
    check("rows", rows, rows.dim(), dev)
    if rows.dim() == 1:
        same("rows", rows.shape, (b * m,))
        stride = 0
    else:
        same("rows", rows.shape, (r, b * m))
        stride = b * m
    _lib.launch("commit_chain", "orca_tx_commit_chain", dev, log.data_ptr(),
                store.data_ptr(), batch.data_ptr(), values.data_ptr(),
                slot.data_ptr(), rows.data_ptr(), r, b, m, tw, vw,
                log.shape[1] - 1, store.shape[1] - 1, stride)
    return log, store
