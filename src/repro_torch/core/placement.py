"""C4 — adaptive data placement: the DDIO/TPH decision on the H100's
tiers, the KVS cache budget and the unified server-memory ledger.

Paper §III-D: DDIO steering every device write into the LLC hurts
NVM-backed regions (256 B access granularity → write amplification), so
ORCA disables DDIO globally and sets the PCIe TPH bit *per memory
region*: DRAM-backed regions go to the cache, NVM-backed regions go to
memory.

On the H100 the tiers are the L2 persisting window (the hot, small
regions: what a hardware-managed 50 MB L2 keeps close across kernels,
NVIDIA H100 data sheet), HBM (streaming) and page-locked host memory (the
persistent, NVM-like regions, never cache-staged). The decision table
(:func:`classify`, :func:`plan`) is the JAX package's, with L2 in the
place of VMEM, budgeted against half of L2 (:data:`CACHE_BUDGET`) just as
the JAX package budgets half of a TPU core's VMEM: the KVS hot-set cache
only pays if its probes stay L2 hits, and ``kvstore.make`` checks it
against that budget. :func:`memory_space_for` names where an operand of a
tier lives; :func:`device_put_tier` moves a live tensor there.

:class:`MemoryBudget` is the ledger of host memory (DRAM for the KV cold
tier, NVM for the durability tier) that both of those consumers charge.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

L2_BYTES = 50 * 1024 * 1024  # H100 L2 (data sheet: 50 MB)
CACHE_BUDGET = L2_BYTES // 2


class Tier(enum.Enum):
    L2 = "l2"  # hot, small: the DDIO/TPH->cache path (L2 persisting window)
    HBM = "hbm"  # streaming: the TPH->memory (DRAM) path
    HOST = "host"  # cold/persistent: the NVM path (never cache-staged)


class MemorySpace(enum.Enum):
    """Where the port keeps an operand of each tier."""

    L2_PERSISTING = "l2_persisting"  # global buffer in the persisting window
    GLOBAL = "global"  # plain global memory (HBM)
    PINNED_HOST = "pinned_host"  # page-locked host memory


@dataclass(frozen=True)
class Region:
    """A registered memory region, as in RNIC memory registration."""

    name: str
    nbytes: int
    access_rate_hz: float = 0.0  # touches per engine step ~ per second
    persistent: bool = False  # needs to survive failure (NVM-like)
    streaming: bool = False  # written once, read once (DMA-like)


def classify(region: Region, l2_left: int = CACHE_BUDGET) -> Tier:
    """The Fig. 5 decision, one region at a time.

    * persistent regions -> HOST (never pollute the cache tier; avoids the
      NVM write-amplification the paper measures);
    * hot small regions (doorbells, pointer buffers, ring headers) -> L2;
    * everything else (bulk tables, KV cache pages) -> HBM streaming.
    """
    if region.persistent:
        return Tier.HOST
    if (region.nbytes <= l2_left and region.access_rate_hz >= 1e3
            and not region.streaming):
        return Tier.L2
    return Tier.HBM


def plan(regions: list[Region], l2_budget: int = CACHE_BUDGET
         ) -> dict[str, Tier]:
    """Greedy knapsack by access density (rate/byte), like LLC way
    allocation."""
    out: dict[str, Tier] = {}
    left = l2_budget
    hot = sorted(
        (r for r in regions if not r.persistent),
        key=lambda r: -(r.access_rate_hz / max(r.nbytes, 1)),
    )
    for r in hot:
        t = classify(r, left)
        out[r.name] = t
        if t is Tier.L2:
            left -= r.nbytes
    for r in regions:
        if r.persistent:
            out[r.name] = Tier.HOST
    return out


def memory_space_for(tier: Tier) -> MemorySpace:
    """Where the port keeps an operand of ``tier``: an L2-persisting global
    buffer, plain global memory, or pinned host memory.

    The JAX package feeds this answer to its Pallas BlockSpecs. The port's
    CUDA wrappers take no BlockSpecs (each kernel stages its own tiles), so
    nothing on the main path consumes it: it is the decision table's
    answer, for callers that place buffers themselves."""
    if tier is Tier.L2:
        return MemorySpace.L2_PERSISTING
    if tier is Tier.HOST:
        return MemorySpace.PINNED_HOST
    return MemorySpace.GLOBAL


def kernel_operand_spaces(regions: list[Region],
                          l2_budget: int = CACHE_BUDGET) -> dict:
    """Memory spaces for a kernel's operands, keyed by region name: the
    Fig. 5 decision of :func:`plan` mapped through
    :func:`memory_space_for`."""
    tiers = plan(regions, l2_budget)
    return {name: memory_space_for(t) for name, t in tiers.items()}


def block_spaces(block_bytes: dict, bulk_bytes: dict,
                 l2_budget: int = CACHE_BUDGET) -> dict:
    """Memory spaces for a kernel's operands from their roles.

    ``block_bytes`` names per-step staged blocks (small and hot: every
    step touches them, so they take the cache treatment); ``bulk_bytes``
    names bulk walked, scattered or aliased arrays (streaming: global
    memory)."""
    regions = [
        Region(n, nb, access_rate_hz=1e6) for n, nb in block_bytes.items()
    ] + [
        Region(n, nb, streaming=True) for n, nb in bulk_bytes.items()
    ]
    return kernel_operand_spaces(regions, l2_budget)


def kvs_cache_bytes(cache_sets: int, cache_ways: int, key_words: int,
                    val_words: int) -> int:
    """Resident footprint of the KVS hot-set cache tier (keys + values +
    meta, int32, sentinel row included). ``kvstore.make`` checks it
    against :data:`CACHE_BUDGET`."""
    return (cache_sets + 1) * cache_ways * (key_words + val_words + 1) * 4


def device_put_tier(x: torch.Tensor, tier: Tier) -> torch.Tensor:
    """Apply the placement to a live tensor.

    ``L2`` and ``HBM`` return ``x`` as it is (the persisting window is a
    property of the access pattern, not of the allocation). ``HOST``
    returns a page-locked host copy of a CUDA tensor; a CPU tensor stays as
    it is. A failure to pin raises: the tensor never silently stays on the
    device."""
    if tier is not Tier.HOST or x.device.type == "cpu":
        return x
    out = torch.empty(x.shape, dtype=x.dtype, device="cpu", pin_memory=True)
    out.copy_(x)
    return out


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
