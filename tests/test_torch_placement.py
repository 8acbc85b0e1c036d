"""The C4 placement table in the port (``repro_torch/core/placement.py``)
against the JAX package's, tier by tier name with the H100's L2 persisting
window in the place of VMEM: ``classify`` and ``plan`` on the regions of
``tests/test_substrates.py``, and with ``kernel_operand_spaces`` and
``block_spaces`` on 252 seeded random region lists with the budget passed
to both, ``memory_space_for`` by the VMEM↔L2 and ANY↔global/host mapping,
and ``device_put_tier`` on CPU tensors (the card's pinned copy is in
``tests/test_torch_cuda.py``)."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from repro.core import placement as jplace
from repro_torch.core import kvstore as tkv
from repro_torch.core import placement as tplace

TIER = {jplace.Tier.VMEM: tplace.Tier.L2, jplace.Tier.HBM: tplace.Tier.HBM,
        jplace.Tier.HOST: tplace.Tier.HOST}


def _pair(**kw):
    return jplace.Region(**kw), tplace.Region(**kw)


def _same_plan(jplan, tplan):
    assert list(jplan) == list(tplan)
    assert {n: TIER[t] for n, t in jplan.items()} == tplan


def test_decision_table_regions_match_jax():
    """tests/test_substrates.py's regions: persistent never cache-staged,
    hot small regions in L2, bulk streaming to HBM."""
    regions = [
        dict(name="pointer_buffer", nbytes=4 * 1024, access_rate_hz=1e6),
        dict(name="embedding", nbytes=8 << 30, access_rate_hz=1e5),
        dict(name="redo_log", nbytes=1 << 20, access_rate_hz=1e5,
             persistent=True),
    ]
    want = [tplace.Tier.L2, tplace.Tier.HBM, tplace.Tier.HOST]
    for kw, tier in zip(regions, want):
        jr, tr = _pair(**kw)
        assert TIER[jplace.classify(jr)] is tplace.classify(tr) is tier


def test_knapsack_respects_budget_like_jax():
    regions = [_pair(name=f"r{i}", nbytes=30 << 20, access_rate_hz=1e5)
               for i in range(8)]
    jplan = jplace.plan([j for j, _ in regions], vmem_budget=64 << 20)
    tplan = tplace.plan([t for _, t in regions], l2_budget=64 << 20)
    _same_plan(jplan, tplan)
    pinned = [n for n, t in tplan.items() if t is tplace.Tier.L2]
    assert 1 <= len(pinned) <= 2


def _random_regions(rng, n):
    """Regions across the decision's edges: sizes around the budget,
    rates around the 1e3 threshold, equal densities, and both flags."""
    out = []
    for i in range(n):
        size = int(rng.choice([0, 1, 64, 4096, 1 << 20, 30 << 20, 1 << 30,
                               int(rng.integers(1, 1 << 26))]))
        rate = float(rng.choice([0.0, 999.0, 1e3, 1e5, 1e6,
                                 float(rng.uniform(0, 2e6))]))
        out.append(dict(name=f"r{i}", nbytes=size, access_rate_hz=rate,
                        persistent=bool(rng.random() < 0.15),
                        streaming=bool(rng.random() < 0.2)))
    return out


@pytest.mark.parametrize("chunk", range(4))
def test_table_matches_jax_on_seeded_region_lists(chunk):
    """252 seeded region lists (4 x 63), the budget given to both:
    ``classify``, ``plan``, and the operand spaces of the same lists
    (``block_spaces`` with the hot regions as blocks, the rest as bulk)."""
    rng = np.random.default_rng(1000 + chunk)
    for _ in range(63):
        regions = _random_regions(rng, int(rng.integers(1, 24)))
        budget = int(rng.choice([0, 4096, 1 << 20, 25 << 20, 64 << 20,
                                 int(rng.integers(0, 1 << 27))]))
        jr = [jplace.Region(**kw) for kw in regions]
        tr = [tplace.Region(**kw) for kw in regions]
        tplan = tplace.plan(tr, l2_budget=budget)
        _same_plan(jplace.plan(jr, vmem_budget=budget), tplan)
        for j, t in zip(jr, tr):
            assert TIER[jplace.classify(j, vmem_left=budget)] is \
                tplace.classify(t, l2_left=budget)
        jsp = jplace.kernel_operand_spaces(jr, vmem_budget=budget)
        tsp = tplace.kernel_operand_spaces(tr, l2_budget=budget)
        assert list(jsp) == list(tsp)
        for n in tsp:
            assert tsp[n] is _space_of(jsp[n], tplan[n])
        hot = {r.name: r.nbytes for r in tr if r.access_rate_hz >= 1e3}
        bulk = {r.name: r.nbytes for r in tr if r.name not in hot}
        jb = jplace.block_spaces(hot, bulk, vmem_budget=budget)
        tb = tplace.block_spaces(hot, bulk, l2_budget=budget)
        assert list(jb) == list(tb)
        for n in tb:
            assert tb[n] is _space_of(jb[n], tplace.Tier.HBM)


def _space_of(jspace, ttier):
    """JAX's memory space against the port's for the same tier."""
    if jspace == pltpu.VMEM:
        return tplace.MemorySpace.L2_PERSISTING
    assert jspace == pltpu.ANY
    return (tplace.MemorySpace.PINNED_HOST if ttier is tplace.Tier.HOST
            else tplace.MemorySpace.GLOBAL)


def test_memory_space_for_maps_vmem_to_l2_and_any_to_global_or_host():
    for jt, tt in TIER.items():
        assert tplace.memory_space_for(tt) is _space_of(
            jplace.memory_space_for(jt), tt)
    assert tplace.memory_space_for(tplace.Tier.HBM) is \
        tplace.MemorySpace.GLOBAL


@pytest.mark.parametrize("seed", range(2))
def test_kernel_operand_spaces_and_block_spaces_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        regions = _random_regions(rng, int(rng.integers(1, 12)))
        budget = int(rng.integers(0, 1 << 26))
        jr = [jplace.Region(**kw) for kw in regions]
        tr = [tplace.Region(**kw) for kw in regions]
        tplan = tplace.plan(tr, l2_budget=budget)
        jsp = jplace.kernel_operand_spaces(jr, vmem_budget=budget)
        tsp = tplace.kernel_operand_spaces(tr, l2_budget=budget)
        assert list(jsp) == list(tsp)
        for n in tsp:
            assert tsp[n] is _space_of(jsp[n], tplan[n])
        blocks = {f"b{i}": int(rng.integers(1, 1 << 22))
                  for i in range(int(rng.integers(0, 5)))}
        bulk = {f"a{i}": int(rng.integers(1, 1 << 30))
                for i in range(int(rng.integers(0, 4)))}
        jb = jplace.block_spaces(blocks, bulk, vmem_budget=budget)
        tb = tplace.block_spaces(blocks, bulk, l2_budget=budget)
        assert list(jb) == list(tb)
        for n in tb:
            assert tb[n] is _space_of(jb[n], tplace.Tier.HBM)


def test_default_budget_is_half_of_l2():
    """The default budget is the port's CACHE_BUDGET (half of L2, what
    kvstore.make checks the cache against), never JAX's VMEM budget."""
    assert tplace.L2_BYTES == 50 * 1024 * 1024
    assert tplace.CACHE_BUDGET == tplace.L2_BYTES // 2
    fits = tplace.Region("fits", tplace.CACHE_BUDGET, access_rate_hz=1e6)
    over = tplace.Region("over", tplace.CACHE_BUDGET + 1, access_rate_hz=1e6)
    assert tplace.classify(fits) is tplace.Tier.L2
    assert tplace.classify(over) is tplace.Tier.HBM
    assert tplace.plan([over, fits]) == {"fits": tplace.Tier.L2,
                                         "over": tplace.Tier.HBM}
    # a region JAX's VMEM budget would take is HBM under the L2 budget
    mid = dict(name="mid", nbytes=40 << 20, access_rate_hz=1e6)
    assert jplace.classify(jplace.Region(**mid)) is jplace.Tier.VMEM
    assert tplace.classify(tplace.Region(**mid)) is tplace.Tier.HBM
    cfg = tkv.KVConfig(num_buckets=16, ways=2, key_words=2, val_words=4,
                       pool_size=32, cache_sets=8, cache_ways=2)
    assert tplace.kvs_cache_bytes(8, 2, 2, 4) <= tplace.CACHE_BUDGET
    assert tkv.make(cfg, device="cpu").cache_keys.shape[0] == 9


@pytest.mark.parametrize("tier", list(tplace.Tier))
def test_device_put_tier_keeps_a_cpu_tensor(tier):
    x = torch.arange(6, dtype=torch.float32)
    assert tplace.device_put_tier(x, tier) is x
