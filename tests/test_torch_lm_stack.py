"""The port's dense decoder stack, model entry points and paged pool
against the JAX package's: every ring-cache decode path, the paged
prefill (chunked and flash) and decode, and the pool's allocator and
host tier. Inputs are made with numpy from a seed; parameters cross from
JAX through ``interop.lm_params_from_numpy``. f32 comparisons hold to 1e-5
(the summation order differs between the frameworks); integer state is
equal bit for bit."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.parallel import sharding as jsharding
from repro.serving import kv_cache as jpk
from repro_torch import configs, interop
from repro_torch.models import model
from repro_torch.parallel import sharding
from repro_torch.serving import kv_cache as pk
from torch_port_helpers import assert_same

TOL = 1e-5
CPU = torch.device("cpu")


def _t(x):
    return interop._tensor(np.asarray(x), CPU)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(interop.to_numpy(got), np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _cfgs(arch, dtype="float32", **kw):
    j = jconfigs.reduced(jconfigs.get_config(arch)).replace(dtype=dtype, **kw)
    t = configs.reduced(configs.get_config(arch)).replace(dtype=dtype, **kw)
    return j, t


def _params(jcfg):
    ctx = jsharding.local_context()
    jp = jmodel.init_params(jax.random.key(1), jcfg, ctx)
    return jp, interop.lm_params_from_numpy(interop.to_numpy(jp), CPU)


# ------------------------ the stack and the model --------------------------

@pytest.mark.parametrize("knobs", [
    {}, {"decode_appended_kv": True}, {"decode_mxu_einsum": True},
    {"decode_appended_kv": True, "kv_cache_layout": "dot"},
    {"sliding_window": 6},
])
def test_dense_prefill_and_decode_match_jax(knobs):
    """prefill + greedy decode steps through the ring caches (every decode
    path of the stack) give JAX's logits and caches."""
    jcfg, tcfg = _cfgs("qwen2.5-14b", **knobs)
    jp, tp = _params(jcfg)
    jctx, tctx = jsharding.local_context(), sharding.local_context()
    rng = np.random.default_rng(5)
    toks = rng.integers(1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jst = jmodel.make_decode_state(jcfg, jctx, 2, 12)
    tst = model.make_decode_state(tcfg, tctx, 2, 12, CPU)
    jst, jl = jmodel.prefill(jp, jnp.asarray(toks), jst, jcfg, jctx, chunk=4)
    tst, tl = model.prefill(tp, torch.as_tensor(toks), tst, tcfg, tctx,
                            chunk=4)
    _close(tl, jl)
    for _ in range(6):
        nxt = jnp.argmax(jl, -1).astype(jnp.int32)
        assert np.array_equal(np.asarray(nxt), tl.argmax(-1).numpy())
        jst, jl = jmodel.decode_step(jp, nxt, jst, jcfg, jctx)
        tst, tl = model.decode_step(tp, _t(nxt), tst, tcfg, tctx)
        _close(tl, jl)
    _close(tst.layers["k"], jst.layers["k"])
    assert np.array_equal(tst.pos.numpy(), np.asarray(jst.pos))


@pytest.mark.parametrize("flash", [False, True])
def test_paged_prefill_and_decode_match_jax(flash):
    """prefill_kv (chunked, or the flash kernel's plain version against
    JAX's interpret-mode kernel) and paged decode steps give JAX's kv,
    logits and pool."""
    jcfg, tcfg = _cfgs("qwen2.5-14b", use_pallas_flash=flash, flash_block=4)
    jp, tp = _params(jcfg)
    jctx, tctx = jsharding.local_context(), sharding.local_context()
    rng = np.random.default_rng(6)
    toks = rng.integers(1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jk, jv, jl = jmodel.prefill_kv(jp, jnp.asarray(toks), jcfg, jctx)
    tk, tv, tl = model.prefill_kv(tp, torch.as_tensor(toks), tcfg, tctx)
    for a, b in ((tk, jk), (tv, jv), (tl, jl)):
        _close(a, b)
    jpc = jmodel.make_paged_kv_config(jcfg, jctx, num_pages=9, page_size=4,
                                      max_pages_per_seq=4)
    tpc = model.make_paged_kv_config(tcfg, tctx, num_pages=9, page_size=4,
                                     max_pages_per_seq=4)
    assert tuple(jpc) == tuple(tpc)
    jkv = jpk.make(jpc, 3, jnp.float32)
    tkv = pk.make(tpc, 3, torch.float32, CPU)
    slots = np.asarray([2, 0], np.int32)
    mask = np.asarray([True, True])
    jkv, jok = jpk.prefill_into_pages(jkv, jpc, jnp.asarray(slots), jk, jv,
                                      jnp.asarray(mask))
    tkv, tok = pk.prefill_into_pages(tkv, tpc, _t(slots), _t(jk), _t(jv),
                                     _t(mask))
    assert_same(jkv, tkv)
    nxt = np.zeros((3,), np.int32)
    nxt[slots] = np.asarray(jnp.argmax(jl, -1))
    active = np.asarray([True, False, True])
    for _ in range(6):
        jkv, jlog, jok = jmodel.paged_decode_step(
            jp, jnp.asarray(nxt), jkv, jpc, jcfg, jctx,
            active=jnp.asarray(active), kernel_backend="ref")
        tkv, tlog, tok = model.paged_decode_step(
            tp, _t(nxt), tkv, tpc, tcfg, tctx, active=_t(active))
        assert np.array_equal(tok.numpy(), np.asarray(jok))
        _close(tlog[active], np.asarray(jlog)[active])
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        assert np.array_equal(tlog[active].argmax(-1).numpy(), nxt[active])
    _close(tkv.k_pages, jkv.k_pages)
    _close(tkv.v_pages, jkv.v_pages)
    for f in ("page_table", "lengths", "free_stack", "free_top", "residency"):
        assert np.array_equal(getattr(tkv, f).numpy(),
                              np.asarray(getattr(jkv, f))), f
    # kv_cache.attend: one layer's normalised attention over the pool
    q = rng.normal(size=(3, tpc.kv_heads, 4, tpc.head_dim)).astype(np.float32)
    for layer in range(tpc.layers):
        _close(pk.attend(tkv, tpc, layer, _t(q)),
               jpk.attend(jkv, jpc, layer, jnp.asarray(q), backend="ref"))


# ---------------------------- the page pool --------------------------------

def test_pool_allocator_and_tiering_match_jax():
    """ensure_capacity / append / release / swap_out / swap_in on the same
    inputs give JAX's states bit for bit, dry pool and cold rows
    included."""
    cfg = jpk.PagedKVConfig(num_pages=6, page_size=2, max_pages_per_seq=3,
                            kv_heads=2, head_dim=4, layers=2)
    tcfg = pk.PagedKVConfig(*cfg)
    rng = np.random.default_rng(7)
    js = jpk.make(cfg, 4, jnp.float32)
    ts = pk.make(tcfg, 4, torch.float32, CPU)
    for step in range(7):
        need = rng.random(4) < 0.8
        js, jok = jpk.ensure_capacity_batch(js, cfg, jnp.asarray(need))
        ts, tok = pk.ensure_capacity_batch(ts, tcfg, _t(need))
        assert np.array_equal(tok.numpy(), np.asarray(jok))
        kn = rng.normal(size=(2, 4, 2, 4)).astype(np.float32)
        vn = rng.normal(size=(2, 4, 2, 4)).astype(np.float32)
        mask = need & np.asarray(jok)
        js = jpk.append_token_batch(js, cfg, jnp.asarray(kn), jnp.asarray(vn),
                                    jnp.asarray(mask))
        ts = pk.append_token_batch(ts, tcfg, _t(kn), _t(vn), _t(mask))
        assert_same(js, ts)
        if step == 3:
            js, jk, jv, jok1 = jpk.swap_out(js, cfg, 1)
            ts, tk, tv, tok1 = pk.swap_out(ts, tcfg, 1)
            assert_same((js, jk, jv, jok1), (ts, tk, tv, tok1))
        if step == 5:
            js, jok2 = jpk.swap_in(js, cfg, 1, jk, jv)
            ts, tok2 = pk.swap_in(ts, tcfg, 1, tk, tv)
            assert_same((js, jok2), (ts, tok2))
        rel = rng.random(4) < 0.3
        js = jpk.release_batch(js, cfg, jnp.asarray(rel))
        ts = pk.release_batch(ts, tcfg, _t(rel))
        assert_same(js, ts)
    assert bool((ts.k_pages[:, -1] == 0).all()), "the sentinel stayed zero"


def test_host_cold_tier_round_trips_bf16_pages():
    cfg = pk.PagedKVConfig(num_pages=4, page_size=2, max_pages_per_seq=2,
                           kv_heads=1, head_dim=4, layers=2)
    tier = pk.HostColdTier(cfg, 4, dtype=torch.bfloat16)
    k = torch.randn((2, 2, 2, 1, 4)).to(torch.bfloat16)
    v = torch.randn((2, 2, 2, 1, 4)).to(torch.bfloat16)
    assert tier.store(3, k, v, 2) and not tier.store(3, k, v, 1)
    k2, v2 = tier.load(3)
    assert k2.dtype == torch.bfloat16 and torch.equal(k2, k)
    assert torch.equal(v2, v)
    tier.drop(3, restored=True)
    assert (tier.pages_used, tier.restores) == (0, 1)


def _pool_invariants(state, cfg):
    """Free pages and mapped pages partition the pool; a COLD slot keeps
    its length but maps no page, a HOT slot maps ceil(len / PS); the
    sentinel page stays zero (the invariants of tests/test_paged_kv.py)."""
    free = set(state.free_stack[: int(state.free_top)].tolist())
    table = state.page_table.numpy()
    mapped = table[table >= 0].tolist()
    assert len(mapped) == len(set(mapped)), "page owned twice"
    assert not (free & set(mapped)), "page both free and mapped"
    assert len(free) + len(mapped) == cfg.num_pages, "pages leaked"
    for s, (n, res) in enumerate(zip(state.lengths.tolist(),
                                     state.residency.tolist())):
        want = 0 if res == pk.COLD else -(-n // cfg.page_size)
        assert (table[s] >= 0).sum() == want
    assert not state.k_pages[:, -1].any() and not state.v_pages[:, -1].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_churn_matches_jax_and_never_leaks(seed):
    """Random grow / release / evict / restore churn (the op mix of
    tests/test_paged_kv.py's property test) through both packages: states
    equal bit for bit after every op, pool invariants held."""
    cfg = jpk.PagedKVConfig(num_pages=6, page_size=2, max_pages_per_seq=3,
                            kv_heads=1, head_dim=4, layers=1)
    tcfg = pk.PagedKVConfig(*cfg)
    b = 4
    js, ts = jpk.make(cfg, b, jnp.float32), pk.make(tcfg, b, torch.float32,
                                                    CPU)
    rng = np.random.default_rng(seed)
    stash = {}
    for _ in range(40):
        op, arg = int(rng.integers(0, 6)), int(rng.integers(0, 3))
        kn = rng.normal(size=(1, b, 1, 4)).astype(np.float32)
        if op in (0, 2):
            need = np.zeros(b, bool)
            need[: arg + 1 if op == 2 else 0] = True
            need[arg] = True
            js, jok = jpk.ensure_capacity_batch(js, cfg, jnp.asarray(need))
            ts, tok = pk.ensure_capacity_batch(ts, tcfg, _t(need))
            m = need & np.asarray(jok)
            js = jpk.append_token_batch(js, cfg, jnp.asarray(kn),
                                        jnp.asarray(kn), jnp.asarray(m))
            ts = pk.append_token_batch(ts, tcfg, _t(kn), _t(kn), _t(m))
        elif op in (1, 5):
            rel = np.ones(b, bool) if op == 5 else np.arange(b) == arg
            js = jpk.release_batch(js, cfg, jnp.asarray(rel))
            ts = pk.release_batch(ts, tcfg, _t(rel))
            for s in np.flatnonzero(rel):
                stash.pop(int(s), None)
        elif op == 3:
            js, jk, jv, jok = jpk.swap_out(js, cfg, arg)
            ts, tk, tv, tok = pk.swap_out(ts, tcfg, arg)
            assert bool(tok) == bool(jok)
            if bool(tok):
                stash[arg] = (jk, jv, tk, tv)
        elif arg in stash:
            jk, jv, tk, tv = stash[arg]
            js, jok = jpk.swap_in(js, cfg, arg, jk, jv)
            ts, tok = pk.swap_in(ts, tcfg, arg, tk, tv)
            assert bool(tok) == bool(jok)
            if bool(tok):
                del stash[arg]
        assert_same(js, ts)
        _pool_invariants(ts, tcfg)
        cold = {s for s in range(b) if int(ts.residency[s]) == pk.COLD}
        assert cold == set(stash)


def test_prefill_into_pages_all_or_nothing_matches_jax():
    """A pool that cannot cover every masked admission admits none, and
    state is untouched; with one admission masked off, the other lands."""
    cfg = jpk.PagedKVConfig(num_pages=3, page_size=4, max_pages_per_seq=4,
                            kv_heads=2, head_dim=8, layers=2)
    tcfg = pk.PagedKVConfig(*cfg)
    k = np.ones((2, 2, 7, 2, 8), np.float32)  # 2 pages a slot, 4 > 3 free
    slots = np.arange(2, dtype=np.int32)
    for mask in ([True, True], [True, False]):
        js, jok = jpk.prefill_into_pages(
            jpk.make(cfg, 2, jnp.float32), cfg, jnp.asarray(slots),
            jnp.asarray(k), jnp.asarray(k), jnp.asarray(mask))
        ts, tok = pk.prefill_into_pages(
            pk.make(tcfg, 2, torch.float32, CPU), tcfg, _t(slots), _t(k),
            _t(k), _t(np.asarray(mask)))
        assert_same((js, jok), (ts, tok))
        assert tok.tolist() == ([False, False] if all(mask) else mask)
        _pool_invariants(ts, tcfg)
