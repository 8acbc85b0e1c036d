"""Fault tolerance for the ORCA request path, on PyTorch.

The port of the JAX package's ``fault`` layer, one module each:

* ``watchdog`` — generic driver utilities: :class:`StragglerDetector`
  (step wall-time EMA), :func:`with_retries` (exponential backoff on
  transient errors), :class:`Heartbeat` (file-mtime liveness).
* ``inject`` — :class:`FaultInjector`, the deterministic seeded fault
  layer at the host step boundary: drop / duplicate / corrupt / delay
  ring entries, suppress doorbells, and surface scheduled replica
  kill/revive events. :class:`NackError` + :func:`request_with_retries`
  are the client-side recovery half.
* ``chain`` — chain-replica failover: :class:`ChainMonitor` (liveness
  authority over ``core.transaction``'s ``live`` mask) and
  :func:`resync_replica` (log-replay resync, bit-for-bit, through the
  ``commit`` kernel on the card).
* ``recovery`` — crash-consistent durability: :class:`DurabilityManager`
  (full snapshots through the atomic checkpoint protocol plus the
  CRC-framed, group-fsynced segment WAL of ``checkpoint.wal``, full vs
  delta decided per flush from measured dirty bytes against the shared
  ``placement.MemoryBudget``) and :func:`recover` (latest committed
  snapshot + torn-tail-truncating WAL replay, bit-for-bit; with ``cold=``
  it restores the LM host cold tier too).
* ``soak`` — the acceptance harness: ``run_soak``, ``run_overload``,
  ``run_crash_soak``, ``run_durability`` and ``run_lm_crash_soak``
  (``scripts/fault_soak_torch.py`` is its command line).
"""
from repro_torch.fault.chain import ChainMonitor, resync_replica
from repro_torch.fault.inject import (
    FAULT_CLASSES, FaultConfig, FaultInjector, NackError,
    request_with_retries,
)
from repro_torch.fault.recovery import (
    DurabilityConfig, DurabilityManager, FlushRecord, derive_tx_cfg, recover,
)
from repro_torch.fault.watchdog import (
    Heartbeat, StragglerDetector, is_transient, with_retries,
)

__all__ = [
    "FAULT_CLASSES", "FaultConfig", "FaultInjector", "NackError",
    "request_with_retries", "ChainMonitor", "resync_replica",
    "DurabilityConfig", "DurabilityManager", "FlushRecord", "derive_tx_cfg",
    "recover",
    "Heartbeat", "StragglerDetector", "is_transient", "with_retries",
]
