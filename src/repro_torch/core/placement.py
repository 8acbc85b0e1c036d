"""C4 — adaptive data placement, the part the KVS needs on the card.

The JAX package budgets the KVS hot-set cache against half of a TPU
core's VMEM, the software-managed fast tier. An H100 has no such tier
that outlives a kernel; the hardware-managed 50 MB L2 is what keeps a hot
region close (NVIDIA H100 data sheet). So the cache is budgeted against
half of L2, just as JAX budgets half of VMEM: the cache tier only pays if
its probes stay L2 hits. The TPU tier machinery (memory spaces for
BlockSpecs) has no counterpart here.
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
