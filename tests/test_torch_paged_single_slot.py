"""The page pool's single-slot forms in the port (``ensure_capacity``,
``append_token``, ``release``, ``kv_bytes_in_use``) against the JAX
package's, on the sequences of ``tests/test_paged_kv.py`` and a seeded
churn of them with evictions: the same seeded kv through both, every
state leaf bit for bit after every call, the same ``ok`` flags and byte
counts. Each form delegates to its batched form through a one-hot mask,
as JAX's does, and writes the pool in place."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.serving import kv_cache as jpk
from repro_torch import serving as tserving
from repro_torch.serving import kv_cache as tpk
from torch_port_helpers import assert_same, t

CFG = dict(num_pages=16, page_size=4, max_pages_per_seq=4, kv_heads=2,
           head_dim=8, layers=2)  # tests/test_paged_kv.py
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# JAX's forms jitted over the config (the slot stays an argument): the
# same functions, compiled once a config instead of dispatched op by op
J = {name: jax.jit(getattr(jpk, name), static_argnums=1)
     for name in ("ensure_capacity", "append_token", "release",
                  "kv_bytes_in_use", "swap_out", "swap_in")}


class _Pools:
    """One JAX and one port pool, driven call for call and compared
    after each."""

    def __init__(self, batch, dtype="float32", **kw):
        self.jcfg = jpk.PagedKVConfig(**{**CFG, **kw})
        self.tcfg = tpk.PagedKVConfig(**{**CFG, **kw})
        self.jdt, self.tdt = DTYPES[dtype]
        self.j = jpk.make(self.jcfg, batch=batch, dtype=self.jdt)
        self.t = tpk.make(self.tcfg, batch=batch, dtype=self.tdt,
                          device="cpu")

    def kv(self, x):
        return jnp.asarray(x, jnp.float32).astype(self.jdt), \
            t(x.astype(np.float32)).to(self.tdt)

    def ensure(self, seq):
        self.j, jok = J["ensure_capacity"](self.j, self.jcfg, seq)
        self.t, tok = tpk.ensure_capacity(self.t, self.tcfg, seq)
        assert tok.dtype == torch.bool and tok.dim() == 0
        assert bool(jok) == bool(tok)
        self.check()
        return bool(tok)

    def append(self, seq, k, v):
        (jk, tk), (jv, tv) = self.kv(k), self.kv(v)
        self.j = J["append_token"](self.j, self.jcfg, seq, jk, jv)
        self.t = tpk.append_token(self.t, self.tcfg, seq, tk, tv)
        self.check()

    def grow(self, seq, k, v):
        ok = self.ensure(seq)
        if ok:
            self.append(seq, k, v)
        return ok

    def release(self, seq):
        self.j = J["release"](self.j, self.jcfg, seq)
        self.t = tpk.release(self.t, self.tcfg, seq)
        self.check()

    def check(self):
        assert_same(self.j, self.t)
        jb = J["kv_bytes_in_use"](self.j, self.jcfg)
        tb = tpk.kv_bytes_in_use(self.t, self.tcfg)
        assert tb.dtype == torch.int64 and int(tb) == int(jb)
        assert int(tpk.pages_in_use(self.t, self.tcfg)) == \
            int(jpk.pages_in_use(self.j, self.jcfg))


def _kv(rng, cfg, n):
    return rng.normal(size=(n, cfg["layers"], cfg["kv_heads"],
                            cfg["head_dim"]))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_append_across_page_boundaries_matches_jax(dtype):
    rng = np.random.default_rng(0)
    pools = _Pools(2, dtype)
    n_tok = {0: 10, 1: 5}  # crosses 2+ page boundaries for seq 0
    ks = {s: _kv(rng, CFG, n_tok[s]) for s in (0, 1)}
    vs = {s: _kv(rng, CFG, n_tok[s]) for s in (0, 1)}
    for step in range(10):
        for s in (0, 1):
            if step < n_tok[s]:
                assert pools.grow(s, ks[s][step], vs[s][step])
    assert pools.t.lengths.tolist() == [10, 5]
    assert int(tpk.pages_in_use(pools.t, pools.tcfg)) == 3 + 2


def test_release_returns_pages_and_reuse_matches_jax():
    pools = _Pools(2)
    k = np.ones((CFG["layers"], CFG["kv_heads"], CFG["head_dim"]))
    for _ in range(9):
        assert pools.grow(0, k, k)
    assert int(tpk.pages_in_use(pools.t, pools.tcfg)) == 3
    pools.release(0)
    assert int(tpk.pages_in_use(pools.t, pools.tcfg)) == 0
    assert int(pools.t.lengths[0]) == 0
    pools.release(0)  # a second release frees nothing twice
    for _ in range(4):
        assert pools.grow(1, k, k)
    assert int(tpk.pages_in_use(pools.t, pools.tcfg)) == 1


def test_batched_ops_match_scalar_loop_and_jax():
    """One batched grow step across every sequence equals the port's
    single-slot calls, which equal JAX's call for call; a batched release
    of two sequences equals two single-slot releases."""
    rng = np.random.default_rng(5)
    pools = _Pools(3, num_pages=8)
    cfg = pools.tcfg
    sa = tpk.make(cfg, batch=3, dtype=torch.float32, device="cpu")
    for step in range(7):
        mask = np.array([True, step % 2 == 0, step < 3])
        k = rng.normal(size=(cfg.layers, 3, cfg.kv_heads, cfg.head_dim))
        v = rng.normal(size=(cfg.layers, 3, cfg.kv_heads, cfg.head_dim))
        sa, ok = tpk.ensure_capacity_batch(sa, cfg, torch.as_tensor(mask))
        assert bool(ok.all())
        sa = tpk.append_token_batch(sa, cfg, t(k).float(), t(v).float(),
                                    torch.as_tensor(mask))
        for s in range(3):
            if mask[s]:
                assert pools.grow(s, k[:, s], v[:, s])
    assert_same(sa, pools.t)
    ra = tpk.release_batch(tpk.clone(sa), cfg,
                           torch.as_tensor([True, False, True]))
    pools.release(0)
    pools.release(2)
    assert_same(ra, pools.t)


def test_pool_exhaustion_backpressure_matches_jax():
    pools = _Pools(1, num_pages=2, max_pages_per_seq=4)
    k = np.zeros((CFG["layers"], CFG["kv_heads"], CFG["head_dim"]))
    oks = [pools.grow(0, k, k) for _ in range(12)]
    # 2 pages x 4 slots = 8 tokens fit; further growth is refused
    assert sum(oks) == 8 and not oks[-1]
    assert int(pools.t.lengths[0]) == 8


def test_table_exhaustion_backpressure_matches_jax():
    """A sequence whose page table is full is refused although the pool
    has free pages."""
    pools = _Pools(2, num_pages=8, max_pages_per_seq=2)
    k = np.ones((CFG["layers"], CFG["kv_heads"], CFG["head_dim"]))
    oks = [pools.grow(1, k, k) for _ in range(10)]
    assert sum(oks) == 8 and oks[8:] == [False, False]
    assert int(tpk.pages_in_use(pools.t, pools.tcfg)) == 2


@pytest.mark.parametrize("seed", range(4))
def test_single_slot_churn_matches_jax(seed):
    """A seeded churn of grow, release, evict and restore across slots
    (COLD slots never allocate or append) stays bit-equal to JAX's."""
    rng = np.random.default_rng(100 + seed)
    kw = dict(num_pages=6, page_size=2, max_pages_per_seq=3, kv_heads=1,
              head_dim=4, layers=1)
    pools = _Pools(4, **kw)
    cfg = {**CFG, **kw}
    stash = {}
    for _ in range(60):
        op, seq = int(rng.integers(0, 4)), int(rng.integers(0, 4))
        if op <= 1:
            k, v = _kv(rng, cfg, 2)
            pools.grow(seq, k, v)
        elif op == 2:
            pools.release(seq)
            stash.pop(seq, None)
        elif seq in stash:
            jk, jv, tk, tv = stash.pop(seq)
            pools.j, jok = J["swap_in"](pools.j, pools.jcfg, seq, jk, jv)
            pools.t, tok = tpk.swap_in(pools.t, pools.tcfg, seq, tk, tv)
            assert bool(jok) == bool(tok)
            if not bool(tok):
                stash[seq] = (jk, jv, tk, tv)
            pools.check()
        else:
            pools.j, jk, jv, jok = J["swap_out"](pools.j, pools.jcfg, seq)
            pools.t, tk, tv, tok = tpk.swap_out(pools.t, pools.tcfg, seq)
            assert bool(jok) == bool(tok)
            if bool(tok):
                stash[seq] = (jk, jv, tk, tv)
            pools.check()
    assert int(pools.t.residency.sum()) == len(stash)


def test_single_slot_forms_write_the_pool_in_place():
    """Like every pool update of the port, the single-slot forms write the
    pool tensors in place: clone a state whose old value is still
    needed."""
    cfg = tpk.PagedKVConfig(**CFG)
    state = tpk.make(cfg, batch=2, dtype=torch.float32, device="cpu")
    before = tpk.clone(state)
    k = torch.ones((cfg.layers, cfg.kv_heads, cfg.head_dim))
    state, ok = tpk.ensure_capacity(state, cfg, 1)
    new = tpk.append_token(state, cfg, 1, k, 2 * k)
    assert new.k_pages is state.k_pages and new.v_pages is state.v_pages
    page = int(new.page_table[1, 0])
    assert bool((state.k_pages[:, page, 0] == 1).all())
    assert bool((state.v_pages[:, page, 0] == 2).all())
    assert not bool(before.k_pages.any())  # the clone kept the old pool
    released = tpk.release(new, cfg, 1)
    assert released.k_pages is state.k_pages
    assert int(tpk.kv_bytes_in_use(released, cfg)) == 0


def test_kv_bytes_in_use_counts_past_int32():
    """At a full-width pool the byte count passes 2^31: the port counts in
    int64, where JAX's int32 product wraps (the same value modulo 2^32)."""
    big = dict(CFG, num_pages=960, layers=48, kv_heads=8, head_dim=128,
               page_size=16)  # chip_smoke.py's lm_crash pool
    jcfg, tcfg = jpk.PagedKVConfig(**big), tpk.PagedKVConfig(**big)
    small = tpk.PagedKVConfig(**CFG)
    state = tpk.make(small, batch=1, dtype=torch.bfloat16, device="cpu")
    state = state._replace(free_top=torch.tensor(0, dtype=torch.int32))
    jstate = jpk.make(jpk.PagedKVConfig(**CFG), batch=1)
    jstate = jstate._replace(free_top=jnp.asarray(0, jnp.int32))
    exact = 960 * 2 * 48 * 16 * 8 * 128 * 2
    assert exact > 2 ** 31
    got = tpk.kv_bytes_in_use(state, tcfg)
    assert got.dtype == torch.int64 and int(got) == exact
    wrapped = int(J["kv_bytes_in_use"](jstate, jcfg))
    assert wrapped % 2 ** 32 == exact % 2 ** 32


def test_serving_exports_the_names_jax_exports():
    names = {n for n in vars(jserving) if not n.startswith("_")}
    names.discard("kv_cache")
    assert names == {
        "PagedKVConfig", "PagedKVState", "append_token",
        "append_token_batch", "attend", "ensure_capacity",
        "ensure_capacity_batch", "kv_bytes_in_use", "make", "pages_in_use",
        "prefill_into_pages", "release", "release_batch"}
    for n in names:
        assert getattr(tserving, n) is getattr(tpk, n), n
    assert tserving.kv_cache is tpk
