"""C4 — adaptive data placement: the KVS cache budget and the unified
server-memory ledger.

The JAX package budgets the KVS hot-set cache against half of a TPU
core's VMEM, the software-managed fast tier. An H100 has no such tier
that outlives a kernel; the hardware-managed 50 MB L2 is what keeps a hot
region close (NVIDIA H100 data sheet). So the cache is budgeted against
half of L2, just as JAX budgets half of VMEM: the cache tier only pays if
its probes stay L2 hits. The TPU tier machinery (memory spaces for
BlockSpecs) has no counterpart here.

:class:`MemoryBudget` is the ledger of host memory (DRAM for the KV cold
tier, NVM for the durability tier) that both of those consumers charge.
"""
from __future__ import annotations

L2_BYTES = 50 * 1024 * 1024  # H100 L2 (data sheet: 50 MB)
CACHE_BUDGET = L2_BYTES // 2


def kvs_cache_bytes(cache_sets: int, cache_ways: int, key_words: int,
                    val_words: int) -> int:
    """Resident footprint of the KVS hot-set cache tier (keys + values +
    meta, int32, sentinel row included). ``kvstore.make`` checks it
    against :data:`CACHE_BUDGET`."""
    return (cache_sets + 1) * cache_ways * (key_words + val_words + 1) * 4


class MemoryBudget:
    """One ledger for the paper's unified DRAM+NVM server-memory view.

    ORCA's fourth component sizes server memory as *one* pool built from
    DRAM and NVM and lets a single placement policy decide what lands on
    which side. Here the DRAM side ("dram") stands for host RAM holding
    evicted KV cold slabs, and the NVM side ("nvm") for the persistence
    tier the durability WAL streams into. Both consumers charge the same
    ledger:

    * ``serving.kv_cache.HostColdTier`` reserves ``cold:<slot>`` on store
      and releases on drop — eviction is refused when the budget is spent,
      not just when the tier's page array is full;
    * ``fault.recovery.DurabilityManager`` folds occupancy into the
      adaptive full-vs-delta split via :meth:`durability_threshold` — the
      fuller the pool, the more the flush policy prefers small deltas over
      full snapshots — and meters bytes via :meth:`note_write`.
    """

    def __init__(self, dram_bytes: int, nvm_bytes: int):
        self.capacity = {"dram": int(dram_bytes), "nvm": int(nvm_bytes)}
        self._used: dict[str, dict[str, int]] = {"dram": {}, "nvm": {}}
        self.bytes_written = {"dram": 0, "nvm": 0}

    def reserve(self, name: str, nbytes: int, side: str = "dram") -> bool:
        """Claim ``nbytes`` under ``name``; False (and no charge) if it
        doesn't fit or the name is already reserved on that side."""
        used = self._used[side]
        if name in used or self.used(side) + int(nbytes) > self.capacity[side]:
            return False
        used[name] = int(nbytes)
        return True

    def release(self, name: str, side: str = "dram") -> int:
        return self._used[side].pop(name, 0)

    def release_prefix(self, prefix: str, side: str = "dram") -> int:
        """Release every reservation whose name starts with ``prefix``
        (tier rebuild after crash recovery). Returns bytes freed."""
        used = self._used[side]
        victims = [n for n in used if n.startswith(prefix)]
        return sum(used.pop(n) for n in victims)

    def used(self, side: str = "dram") -> int:
        return sum(self._used[side].values())

    def free(self, side: str = "dram") -> int:
        return max(0, self.capacity[side] - self.used(side))

    def free_frac(self, side: str = "dram") -> float:
        cap = self.capacity[side]
        return 1.0 if cap <= 0 else self.free(side) / cap

    def note_write(self, nbytes: int, side: str = "nvm") -> None:
        """Meter streamed bytes (WAL appends / snapshot writes)."""
        self.bytes_written[side] += int(nbytes)

    def durability_threshold(self, base: float) -> float:
        """Adaptive dirty-fraction threshold under memory pressure.

        With a free pool the base threshold stands (full snapshots — and
        their shorter replay chains — are affordable). As DRAM occupancy
        rises (cold slabs crowding the pool), the threshold climbs toward
        1.0 so flushes prefer the smaller delta write: the same
        more-precious-when-fuller rule the cold tier applies to pages.
        """
        pressure = 1.0 - self.free_frac("dram")
        return float(min(1.0, base + (1.0 - base) * pressure))
