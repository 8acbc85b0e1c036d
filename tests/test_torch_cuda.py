"""The CUDA kernels of the PyTorch port against their plain versions, on a
card. These need an NVIDIA GPU and nvcc, skip without them, and import
nothing of JAX, so they run where the port runs:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import hash_probe_cases as hpc
import kvs_commit_cases as kcc
from embedding_cases import COPY_BYTES, WIDTHS, edge_case, \
    plain_with_zero_rows
from hash_probe_cases import SHAPES
from repro_torch import interop
from repro_torch.core import dlrm
from repro_torch.core import engine as eng
from repro_torch.core import kvstore as kv
from repro_torch.core import transaction as tx
from repro_torch.core import tx_app
from repro_torch.kernels import embedding_reduce as er
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hash_probe as hp
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.kernels import tx_commit as tc
from tx_commit_cases import CASES as TX_CASES
from tx_commit_cases import IN_RANGE as TX_IN_RANGE
from tx_commit_cases import edge_case as tx_edge_case
from tx_commit_cases import plain_dropping_out_of_range, replica, to_torch

pytestmark = pytest.mark.cuda

BATCHES = [1, 7, 32, 300]
# the lookups' edge cases: one warp, a few CTAs, many CTAs of 256 threads
LOOKUP_BATCHES = [1, 37, 4099]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _i32(rng, lo, hi, shape):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))


def _flat(x):
    """The leaves of a nested dict/list of numpy arrays, in order."""
    if isinstance(x, dict):
        x = list(x.values())
    return [y for v in x for y in _flat(v)] if isinstance(x, list) else [x]


def _same(want, got, what):
    """Two states (tensors, tuples, NamedTuples) equal leaf for leaf, in
    dtype, shape and value."""
    a = _flat(interop.to_numpy(want))
    b = _flat(interop.to_numpy(got))
    assert len(a) == len(b), what
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y), what


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("b", BATCHES)
def test_kernels_match_plain_versions(dev, shape, b):
    """Random sentinel-resident states (ways > 32 included, so a warp
    loops), queries that hit and miss, sentinel-aimed commits."""
    nb, w, kw, np_, vw = shape
    rng = np.random.default_rng(nb + w + b)
    bk = _i32(rng, -2, 4, (nb + 1, w, kw))
    bp = _i32(rng, -1, np_, (nb + 1, w))
    bk[nb], bp[nb] = 0, 0
    pool = _i32(rng, -999, 999, (np_ + 1, vw))
    pool[np_] = 0
    keys = _i32(rng, -2, 4, (b, kw))
    h1 = _i32(rng, 0, nb + 1, (b,))
    h2 = _i32(rng, 0, nb, (b,))
    d = lambda x: x.to(dev)  # noqa: E731
    _same(ref.hash_probe(bk, bp, keys, h1, h2),
          hp.probe(d(bk), d(bp), d(keys), d(h1), d(h2)), "probe")
    ptr = _i32(rng, 0, np_ + 1, (b,))
    _same(ref.fetch(pool, ptr), hp.fetch(d(pool), d(ptr)), "fetch")
    _same(ref.hash_get(bk, bp, pool, keys, h1, h2),
          hp.get(d(bk), d(bp), d(pool), d(keys), d(h1), d(h2)), "get")
    cv = _i32(rng, -999, 999, (nb + 1, w, vw))
    cm = _i32(rng, 0, 3, (nb + 1, w))
    cv[nb], cm[nb] = 0, 0
    cset = _i32(rng, 0, nb + 1, (b,))
    _same(ref.cache_probe(bk, cv, cm, keys, cset),
          hp.cache_probe(d(bk), d(cv), d(cm), d(keys), d(cset)),
          "cache_probe")
    # unique live targets, the rest aimed at the sentinel rows
    pairs = torch.from_numpy(rng.permutation(nb * w)[:b].astype(np.int32))
    n = pairs.shape[0]
    tb = torch.full((b,), nb, dtype=torch.int32)
    tw = _i32(rng, 0, w, (b,))
    live = torch.from_numpy(rng.random(n) < 0.7)
    tb[:n] = torch.where(live, pairs // w, nb)
    tw[:n] = torch.where(live, pairs % w, tw[:n])
    rows = torch.from_numpy(rng.permutation(np_)[:b].astype(np.int32))
    wp = torch.full((b,), np_, dtype=torch.int32)
    wp[: rows.shape[0]] = rows
    vals = _i32(rng, -999, 999, (b, vw))
    bptr_val = _i32(rng, 0, np_, (b,))
    want = ref.hash_put(bk.clone(), bp.clone(), pool.clone(), keys, vals, tb,
                        tw, bptr_val, wp)
    got = hp.insert(d(bk), d(bp), d(pool), d(keys), d(vals), d(tb), d(tw),
                    d(bptr_val), d(wp))
    torch.cuda.synchronize()
    _same(want, got, "insert")


def test_wrappers_reject_bad_tensors(dev):
    bk = torch.zeros((5, 2, 2), dtype=torch.int32, device=dev)
    bp = torch.zeros((5, 2), dtype=torch.int32, device=dev)
    keys = torch.zeros((3, 2), dtype=torch.int32, device=dev)
    h = torch.zeros((3,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        hp.probe(bk, bp, keys.to(torch.int64), h, h)
    with pytest.raises(ValueError, match="contiguous"):
        hp.probe(bk, bp, torch.zeros((2, 3), dtype=torch.int32,
                                     device=dev).t(), h, h)
    with pytest.raises(ValueError, match="shape"):
        hp.probe(bk, bp, keys, h[:2], h)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hp.probe(bk.cpu(), bp.cpu(), keys.cpu(), h.cpu(), h.cpu())


def test_get_wrapper_rejects_bad_tensors(dev):
    i32 = dict(dtype=torch.int32, device=dev)
    bk, bp = torch.zeros((5, 2, 2), **i32), torch.zeros((5, 2), **i32)
    pool, keys = torch.zeros((9, 4), **i32), torch.zeros((3, 2), **i32)
    h = torch.zeros((3,), **i32)
    with pytest.raises(TypeError, match="dtype"):
        hp.get(bk, bp, pool.to(torch.int64), keys, h, h)
    with pytest.raises(ValueError, match="contiguous"):
        hp.get(bk, bp, torch.zeros((4, 9), **i32).t(), keys, h, h)
    with pytest.raises(ValueError, match="shape"):
        hp.get(bk, torch.zeros((5, 3), **i32), pool, keys, h, h)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hp.get(bk, bp, pool.cpu(), keys, h, h)


@pytest.mark.parametrize("b", LOOKUP_BATCHES)
@pytest.mark.parametrize("shape", hpc.PROBE_SHAPES)
@pytest.mark.parametrize("case", hpc.PROBE_CASES)
def test_probe_edge_cases_match_plain_version(dev, case, shape, b):
    """Every lookup edge case (``tests/hash_probe_cases.py``) at the serve
    widths and every SHAPES entry: the kernel equals the plain version,
    ids out of range matching nothing."""
    nb, w, kw = shape
    c = hpc.probe_case(case, seed=nb + b, nb=nb, w=w, kw=kw, b=b)
    got = hp.probe(**hpc.to_torch(c, dev))
    torch.cuda.synchronize()
    _same(hpc.plain_probe(**hpc.to_torch(c)), got, f"probe {case}")


@pytest.mark.parametrize("b", LOOKUP_BATCHES)
@pytest.mark.parametrize("shape", hpc.CACHE_SHAPES)
@pytest.mark.parametrize("case", hpc.CACHE_CASES)
def test_cache_probe_edge_cases_match_plain_version(dev, case, shape, b):
    """The same for ``cache_probe``: the max matching way with meta > 0
    and its line, set ids out of range hitting nothing."""
    cs, cw, kw, vw = shape
    c = hpc.cache_case(case, seed=cs + b, cs=cs, cw=cw, kw=kw, vw=vw, b=b)
    got = hp.cache_probe(**hpc.to_torch(c, dev))
    torch.cuda.synchronize()
    _same(hpc.plain_cache_probe(**hpc.to_torch(c)), got,
          f"cache_probe {case}")


@pytest.mark.parametrize("b", LOOKUP_BATCHES)
@pytest.mark.parametrize("shape", hpc.GET_SHAPES)
@pytest.mark.parametrize("case", hpc.GET_CASES)
def test_get_walk_edge_cases_match_plain_version(dev, case, shape, b):
    """Every GET walk case at both instances (the serve widths, then the
    run-time ones): ``get_walk`` equals the plain ``hash_get``, ids out
    of range matching nothing, a found pointer past NP reading row NP;
    one launch a call."""
    nb, w, kw, np_, vw = shape
    c = hpc.get_case(case, seed=nb + b, nb=nb, w=w, kw=kw, np_=np_, vw=vw,
                     b=b)
    hp.reset_launches()
    got = hp.get(**hpc.to_torch(c, dev))
    torch.cuda.synchronize()
    assert hp.launches == {**dict.fromkeys(hp.KERNELS, 0), "get_walk": 1}
    _same(hpc.plain_get(**hpc.to_torch(c)), got, f"get {case}")


@pytest.mark.parametrize("name", ["keys", "bucket_keys"])
def test_get_walk_unaligned_arrays_take_4_byte_loads(dev, name):
    """Keys or bucket keys off the 8-byte grid at the serve widths: the
    run-time instance, the same answers."""
    c = hpc.get_case("retargeted", seed=5, nb=16, w=8, kw=2, np_=1000,
                     vw=16, b=256)
    t = hpc.to_torch(c, dev)
    t[name] = _unaligned(t[name])
    _same(hpc.plain_get(**hpc.to_torch(c)), hp.get(**t),
          f"get, {name} unaligned")


def test_lookups_at_the_load_batch(dev):
    """65,536 requests (the load phase's batch) at the serve widths: 4,096
    CTAs of 256 threads, equal to the plain versions."""
    b = 65536
    c = hpc.probe_case("random", seed=1, nb=4096, w=8, kw=2, b=b)
    _same(hpc.plain_probe(**hpc.to_torch(c)),
          hp.probe(**hpc.to_torch(c, dev)), "probe at 65,536")
    c = hpc.cache_case("random", seed=2, cs=4096, cw=4, kw=2, vw=16, b=b)
    _same(hpc.plain_cache_probe(**hpc.to_torch(c)),
          hp.cache_probe(**hpc.to_torch(c, dev)), "cache_probe at 65,536")
    c = hpc.get_case("random", seed=6, nb=4096, w=8, kw=2, np_=1000, vw=16,
                     b=b)
    _same(hpc.plain_get(**hpc.to_torch(c)), hp.get(**hpc.to_torch(c, dev)),
          "get at 65,536")


def _unaligned(t):
    """A contiguous copy of ``t`` on the card whose base is 4-byte but not
    8-byte aligned (one word into a flat buffer)."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 8 == 4
    return out


@pytest.mark.parametrize("name", ["keys", "bucket_keys"])
def test_probe_unaligned_arrays_take_4_byte_loads(dev, name):
    """Keys or bucket keys off the 8-byte grid: the entry point takes the
    run-time instance (4-byte loads), with the same answers."""
    c = hpc.probe_case("random", seed=3, nb=16, w=8, kw=2, b=37)
    t = hpc.to_torch(c, dev)
    t[name] = _unaligned(t[name])
    _same(hpc.plain_probe(**hpc.to_torch(c)), hp.probe(**t),
          f"probe, {name} unaligned")


@pytest.mark.parametrize("name", ["keys", "cache_keys", "cache_vals"])
def test_cache_probe_unaligned_arrays_take_4_byte_loads(dev, name):
    """The same for ``cache_probe``, cache_vals off the 16-byte grid too."""
    c = hpc.cache_case("random", seed=4, cs=16, cw=4, kw=2, vw=16, b=37)
    t = hpc.to_torch(c, dev)
    t[name] = _unaligned(t[name])
    _same(hpc.plain_cache_probe(**hpc.to_torch(c)), hp.cache_probe(**t),
          f"cache_probe, {name} unaligned")


def test_lookups_refuse_a_batch_past_their_lane_index(dev):
    """2^26 + 1 requests: past the lookups' 32-bit lane index, so the C
    entry points refuse the launch and the wrappers raise."""
    b = (1 << 26) + 1
    i32 = dict(dtype=torch.int32, device=dev)
    keys, ids = torch.zeros((b, 2), **i32), torch.zeros((b,), **i32)
    with pytest.raises(RuntimeError, match="CUDA error"):
        hp.probe(torch.zeros((5, 8, 2), **i32), torch.zeros((5, 8), **i32),
                 keys, ids, ids)
    with pytest.raises(RuntimeError, match="CUDA error"):
        hp.cache_probe(torch.zeros((5, 4, 2), **i32),
                       torch.zeros((5, 4, 16), **i32),
                       torch.zeros((5, 4), **i32), keys, ids)
    with pytest.raises(RuntimeError, match="CUDA error"):
        hp.get(torch.zeros((5, 8, 2), **i32), torch.zeros((5, 8), **i32),
               torch.zeros((9, 1), **i32), keys, ids, ids)


def test_cache_probe_wrapper_rejects_bad_tensors(dev):
    i32 = dict(dtype=torch.int32, device=dev)
    ck, cv = torch.zeros((5, 4, 2), **i32), torch.zeros((5, 4, 16), **i32)
    cm, keys = torch.zeros((5, 4), **i32), torch.zeros((3, 2), **i32)
    cset = torch.zeros((3,), **i32)
    with pytest.raises(TypeError, match="dtype"):
        hp.cache_probe(ck, cv, cm, keys, cset.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        hp.cache_probe(ck, torch.zeros((5, 16, 4), **i32).transpose(1, 2),
                       cm, keys, cset)
    with pytest.raises(ValueError, match="shape"):
        hp.cache_probe(ck, cv, torch.zeros((5, 3), **i32), keys, cset)
    with pytest.raises(ValueError, match="CUDA tensors"):
        hp.cache_probe(ck.cpu(), cv.cpu(), cm.cpu(), keys.cpu(), cset.cpu())


def _commit(t):
    """Both commit kernels on a case's tensors, IN PLACE."""
    hp.commit_buckets(t["bucket_keys"], t["bucket_ptr"], t["keys"], t["tb"],
                      t["tw"], t["bptr_val"])
    hp.write_rows(t["pool"], t["vals"], t["wp"])
    torch.cuda.synchronize()
    return t["bucket_keys"], t["bucket_ptr"], t["pool"]


@pytest.mark.parametrize("b", kcc.BATCHES)
@pytest.mark.parametrize("shape", kcc.SHAPES)
@pytest.mark.parametrize("case", kcc.CASES)
def test_commit_edge_cases_match_plain_version(dev, case, shape, b):
    """Every commit edge case (``tests/kvs_commit_cases.py``): the kernels
    equal the plain versions bit for bit, non-zero sentinel rows
    included, targets outside the arrays skipped."""
    nb, w, kw, np_, vw = shape
    c = kcc.commit_case(case, seed=nb * 7 + vw + b, nb=nb, w=w, kw=kw,
                        np_=np_, vw=vw, b=b)
    _same(kcc.plain_commit(**kcc.to_torch(c)),
          _commit(kcc.to_torch(c, dev)), f"commit {case}")


@pytest.mark.parametrize("names", [("keys",), ("bucket_keys",), ("pool",),
                                   ("vals",), ("keys", "vals")])
def test_commit_unaligned_views_take_the_run_time_instances(dev, names):
    """Arrays one word off the 8- and 16-byte grid: the entry points take
    the run-time instances (4-byte words), with the same result."""
    c = kcc.commit_case("some_dead", seed=6, nb=64, w=8, kw=2, np_=400,
                        vw=16, b=300)
    t = kcc.to_torch(c, dev)
    for name in names:
        t[name] = _unaligned(t[name])
    _same(kcc.plain_commit(**kcc.to_torch(c)), _commit(t),
          f"commit, {names} unaligned")


def _loaded_store(dev, n_keys, b, put_share, seed):
    """A store of 2^14 buckets x 8 ways and 2^17 64-byte rows with
    ``n_keys`` keys loaded, and a planned batch of ``b`` requests on it:
    loaded and fresh keys, PUT where a draw falls under ``put_share`` (the
    rest masked, as ``app_step`` masks GETs). Returns (state, keys, vals,
    plan)."""
    cfg = kv.KVConfig(num_buckets=1 << 14, ways=8, key_words=2,
                      val_words=16, pool_size=1 << 17)
    g = torch.Generator(device=dev).manual_seed(seed)
    state = kv.make(cfg, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    loaded = torch.randint(-2**31, 2**31 - 1, (n_keys, 2), generator=g,
                           **i32)
    state, _ = kv.put(state, loaded, torch.randint(
        -999, 999, (n_keys, 16), generator=g, **i32), backend="ref")
    keys = torch.where(
        (torch.rand((b, 1), generator=g, device=dev) < 0.5),
        loaded[torch.randint(0, n_keys, (b,), generator=g, device=dev)],
        torch.randint(-2**31, 2**31 - 1, (b, 2), generator=g, **i32))
    vals = torch.randint(-2**31, 2**31 - 1, (b, 16), generator=g, **i32)
    mask = torch.rand((b,), generator=g, device=dev) < put_share
    return state, keys, vals, kv.plan_put(state, keys, mask, backend="ref")


@pytest.mark.parametrize("b,put_share", [(256, 0.05), (65536, 1.0)])
def test_commit_at_the_serve_mix_and_the_load_batch(dev, b, put_share):
    """The engine's batch with 5% PUTs (about 244 of 256 entries dead) and
    the load phase's 65,536 fresh and loaded keys: the kernels equal the
    plain versions bit for bit on the planned batch."""
    state, keys, vals, plan = _loaded_store(dev, 20000, b, put_share, b)
    dead = int((plan.tb == state.num_buckets).sum())
    assert (dead > 0.9 * b) if put_share < 1 else (dead < b)
    bk, bp, pool = (x.clone() for x in (state.bucket_keys, state.bucket_ptr,
                                        state.pool))
    ref.commit_buckets(bk, bp, keys, plan.tb, plan.tw, plan.bptr_val)
    ref.write_rows(pool, vals, plan.wp)
    got = (state.bucket_keys, state.bucket_ptr, state.pool)
    hp.commit_buckets(*got[:2], keys, plan.tb, plan.tw, plan.bptr_val)
    hp.write_rows(got[2], vals, plan.wp)
    torch.cuda.synchronize()
    _same((bk, bp, pool), got, f"commit at B = {b}")


def test_commits_refuse_a_batch_past_their_lane_index(dev):
    """2^26 + 1 entries: past the commits' 32-bit lane index, so the C
    entry points refuse the launch and the wrappers raise."""
    b = (1 << 26) + 1
    i32 = dict(dtype=torch.int32, device=dev)
    ids = torch.zeros((b,), **i32)
    with pytest.raises(RuntimeError, match="CUDA error"):
        hp.commit_buckets(torch.zeros((5, 8, 2), **i32),
                          torch.zeros((5, 8), **i32),
                          torch.zeros((b, 2), **i32), ids, ids, ids)
    with pytest.raises(RuntimeError, match="CUDA error"):
        hp.write_rows(torch.zeros((5, 16), **i32),
                      torch.zeros((b, 16), **i32), ids)


@pytest.mark.parametrize("cache_sets", [0, 16])
def test_engine_kvs_kernels_equal_plain_on_the_card(dev, cache_sets):
    """The same seeded traffic through an ``auto`` (kernel) and a ``ref``
    (plain) engine on the card: equal responses and final states, and
    every kernel of the path launched."""
    cfg = kv.KVConfig(num_buckets=64, ways=4, key_words=2, val_words=8,
                      pool_size=200, cache_sets=cache_sets, cache_ways=2)
    w = kv.request_words(cfg)
    runs = {}
    for backend in ("auto", "ref"):
        ecfg = eng.EngineConfig(num_queues=4, capacity=16, req_words=w,
                                resp_words=w, budget=16,
                                kernel_backend=backend)
        state = eng.make(ecfg, kv.make(cfg, device=dev))
        app = eng.bind_app(kv.app_step, cfg, ecfg)
        rng = np.random.default_rng(3)
        hp.reset_launches()
        out = []
        for _ in range(12):
            pl = np.zeros((4, w), np.int32)
            pl[:, 0] = rng.integers(1, 3, 4)
            pl[:, 1:3] = rng.integers(0, 6, (4, 2))
            pl[:, 3:] = rng.integers(-99, 99, (4, w - 3))
            state = eng.inject(state, torch.arange(4), torch.from_numpy(pl))
            state, stats = eng.run_steps(state, app, ecfg, 2)
            pay, counts, state = eng.drain_responses(state, 16)
            out.append((stats, pay, counts))
        torch.cuda.synchronize()
        runs[backend] = (interop.to_numpy((state, out)), dict(hp.launches))
    (a, launches), (b, plain_launches) = runs["auto"], runs["ref"]
    for x, y in zip(_flat(a), _flat(b), strict=True):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    # the GET walk is one get_walk launch: fetch runs on no engine path
    want = {"probe", "get_walk", "commit_buckets", "write_rows"}
    if cache_sets:
        want.add("cache_probe")
    assert all(launches[k] > 0 for k in want), launches
    assert launches["fetch"] == 0, launches
    assert not any(plain_launches.values())


# ------------------------------ TX ------------------------------------------

def _tx_plan(rng, cfg, b, dev):
    """A planned batch of b random transactions on few offsets (conflicts,
    intra-tx duplicates), on ``dev``."""
    w = tx.tx_words(cfg)
    batch = np.zeros((b, w), np.int32)
    batch[:, 0] = rng.integers(1, cfg.max_ops + 1, b)
    ops = batch[:, 1:].reshape(b, cfg.max_ops, 1 + cfg.val_words)
    ops[..., 0] = rng.integers(0, max(cfg.num_keys // 2, 1),
                               (b, cfg.max_ops))
    ops[..., 1:] = rng.integers(-999, 999, (b, cfg.max_ops, cfg.val_words))
    batch[:, 1:] = ops.reshape(b, -1)
    return tx.plan_commit(torch.from_numpy(batch).to(dev), cfg)


@pytest.mark.parametrize("shape", [(16, 2, 3, 3, 4), (300, 16, 8, 3, 64),
                                   (64, 33, 5, 1, 8), (40, 3, 4, 3, 16),
                                   (64, 40, 4, 3, 8)])
@pytest.mark.parametrize("b", [1, 7, 300])
def test_tx_kernels_match_plain_versions(dev, shape, b):
    """commit and commit_chain against their plain versions: random
    sentinel-resident states, skewed tails (so slots lap the ring), a
    dead replica, shared and per-replica rows. VW = 2, 3 and 33 rule out
    16-byte stores; at VW = 40 the sentinel rows of three replicas
    outnumber a CTA's threads, so they are zeroed after the targets are
    read."""
    nk, vw, m, r, lc = shape
    cfg = tx.TxConfig(num_keys=nk, val_words=vw, max_ops=m, chain_len=r,
                      log_capacity=lc)
    rng = np.random.default_rng(nk + b)
    store = _i32(rng, -99, 99, (r, nk + 1, vw))
    log = _i32(rng, -99, 99, (r, lc + 1, tx.tx_words(cfg)))
    store[:, nk], log[:, lc] = 0, 0
    plan = _tx_plan(rng, cfg, b, "cpu")
    live = torch.ones(r, dtype=torch.bool)
    live[r // 2] = r == 1
    tail = _i32(rng, 0, 3 * lc, (r,))
    chain = tx.ReplicaState(store, log, tail, tail, live)
    d = lambda x: x.to(dev)  # noqa: E731
    want = tx.chain_commit_apply(tx.ReplicaState(*(x.clone() for x in chain)),
                                 plan, kernel_backend="ref")
    got = tx.chain_commit_apply(tx.ReplicaState(*(d(x) for x in chain)),
                                type(plan)(*(d(x) for x in plan)),
                                kernel_backend="cuda")
    torch.cuda.synchronize()
    _same(want, got, "commit_chain (per-replica rows)")
    # shared rows: every replica live; live slots unique per replica, as
    # the plan makes them (only the last LC ranks of a lapping batch keep
    # a slot), since the kernel's writes to one row race
    survives = plan.log_rank >= plan.n_commit - lc
    slot = torch.where(plan.proceed & survives,
                       (tail[:, None] + plan.log_rank) % lc, lc)
    slot = slot.to(torch.int32)
    args = (plan.batch, plan.values, slot, plan.store_rows)
    want = ref.tx_commit_chain(log.clone(), store.clone(), *args)
    got = tc.commit_chain(d(log), d(store), *(d(x) for x in args))
    torch.cuda.synchronize()
    _same(want, got, "commit_chain (shared rows)")
    # one replica
    rep = tx.ReplicaState(store[0], log[0], tail[0], tail[0],
                          torch.tensor(True))
    want = tx.replica_commit(tx.ReplicaState(*(x.clone() for x in rep)), plan)
    got = tx.replica_commit(tx.ReplicaState(*(d(x) for x in rep)),
                            type(plan)(*(d(x) for x in plan)),
                            kernel_backend="cuda")
    torch.cuda.synchronize()
    _same(want, got, "commit")


@pytest.mark.parametrize("vw", [3, 16])
@pytest.mark.parametrize("kernel", ["commit", "commit_chain_shared",
                                    "commit_chain_per_replica"])
@pytest.mark.parametrize("case", TX_CASES)
def test_tx_kernels_edge_cases_match_plain_versions(dev, case, kernel, vw):
    """commit (R = 1) and commit_chain (R = 3, shared or per-replica rows)
    against their plain versions on sentinel rows that are not zero on
    entry (aimed at, not aimed at, every target a sentinel) and on targets
    outside [0, LC] and [0, NK], which the kernel skips (the plain version
    then runs on the targets in range). VW = 3 rules out 16-byte stores;
    VW = 16 is the engine's width (TW = 137)."""
    c = tx_edge_case(case, seed=vw + len(kernel), r=3, b=40, m=8, vw=vw,
                     lc=64, nk=1024, shared_rows=kernel.endswith("shared"))
    if kernel == "commit":
        c = replica(c)
    names = ("log", "store", "batch", "values", "slot", "rows")
    want_args = [to_torch(c)[k] for k in names]
    got_args = [to_torch(c, dev)[k] for k in names]
    if case not in TX_IN_RANGE:
        plain = plain_dropping_out_of_range
    elif kernel == "commit":
        plain = ref.tx_commit
    else:
        plain = ref.tx_commit_chain
    want = plain(*want_args)
    got = (tc.commit if kernel == "commit" else tc.commit_chain)(*got_args)
    torch.cuda.synchronize()
    _same(want, got, f"{kernel} {case} vw={vw}")


@pytest.mark.parametrize("vw", [3, 16])
def test_tx_commit_at_the_replay_shape(dev, vw):
    """One record a launch, proceed forced (``replay_records``' plan), at
    B = 1 into a replica whose store sentinel row is not zero on entry:
    the kernel's replica equals the plain version's after each record."""
    cfg = tx.TxConfig(num_keys=512, val_words=vw, max_ops=8, chain_len=1,
                      log_capacity=16)
    rng = np.random.default_rng(vw)
    w = tx.tx_words(cfg)
    records = np.zeros((20, w), np.int32)
    records[:, 0] = rng.integers(1, cfg.max_ops + 1, 20)
    ops = records[:, 1:].reshape(20, cfg.max_ops, 1 + vw)
    ops[..., 0] = rng.integers(0, 40, (20, cfg.max_ops))  # duplicates
    ops[..., 1:] = rng.integers(-999, 999, (20, cfg.max_ops, vw))
    records[:, 1:] = ops.reshape(20, -1)
    rep = tx.make_replica(cfg, device="cpu")
    rep.store.copy_(_i32(rng, -99, 99, rep.store.shape))
    rep.log.copy_(_i32(rng, -99, 99, rep.log.shape))
    rep.log[-1] = 0
    want, got = rep, tx.ReplicaState(*(x.to(dev) for x in rep))
    one = torch.ones((1,), dtype=torch.bool)
    tc.reset_launches()
    for rec in torch.from_numpy(records):
        plan = tx.plan_commit(rec[None], cfg, proceed=one)
        want = tx.replica_commit(want, plan, kernel_backend="ref")
        plan = type(plan)(*(x.to(dev) for x in plan))
        got = tx.replica_commit(got, plan, kernel_backend="cuda")
        torch.cuda.synchronize()
        _same(want, got, "replayed record")
    assert tc.launches["commit"] == 20
    assert not want.store[-1].any()


def test_tx_wrappers_reject_bad_tensors(dev):
    cfg = tx.TxConfig(num_keys=8, val_words=2, max_ops=2, chain_len=2,
                      log_capacity=4)
    chain = tx.make_chain(cfg, device=dev)
    plan = _tx_plan(np.random.default_rng(0), cfg, 3, dev)
    slot = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shape"):
        tc.commit_chain(chain.log, chain.store, plan.batch, plan.values,
                        slot[:1], plan.store_rows)
    with pytest.raises(TypeError, match="dtype"):
        tc.commit_chain(chain.log, chain.store, plan.batch, plan.values,
                        slot.long(), plan.store_rows)
    with pytest.raises(ValueError, match="contiguous"):
        tc.commit(chain.log[0], chain.store[0], plan.batch, plan.values,
                  torch.zeros((3, 2), dtype=torch.int32, device=dev)[:, 0],
                  plan.store_rows)


# ------------------------------ DLRM ----------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,segs,d", [(1, 1, 8), (300, 40, 64), (70, 9, 200)])
def test_embedding_reduce_matches_plain_version(dev, dtype, n, segs, d):
    """Bit for bit against the plain version: empty segments, duplicate
    rows, D above one 128-column chunk, bf16 tables."""
    rng = np.random.default_rng(n + d)
    table = torch.from_numpy(rng.normal(size=(50, d)).astype(np.float32))
    table = table.to(dtype)
    idx = _i32(rng, 0, 50, (n,))
    idx[n // 2:] = idx[: n - n // 2].clone()
    keep = np.setdiff1d(np.arange(segs), [0, segs // 2])
    seg = torch.from_numpy(np.sort(rng.choice(keep if len(keep) else [0], n))
                           .astype(np.int32))
    want = ref.embedding_reduce(table, idx, seg, segs)
    got = er.embedding_reduce(table.to(dev), idx.to(dev), seg.to(dev), segs)
    torch.cuda.synchronize()
    _same(want, got, "embedding_reduce")


@pytest.mark.parametrize("dtype,d", WIDTHS)
def test_embedding_reduce_walk_edge_cases(dev, dtype, d):
    """Bit for bit against the plain version, a row outside the table
    reading as zero: segments of 1, 31, 32, 33, 100 and 1,000 lookups (so
    chunks cross the two stages), empty first, middle and last segments,
    seg_ids outside [0, S), negative and too-large rows (one a segment's
    first), an all-(-0.0) segment, at each copy width: 16 bytes (f32 D = 8
    and 64, bf16 D = 64 and 200), 4 (f32 D = 6 and 70, bf16 D = 100) and
    2 (bf16 D = 33)."""
    table, idx, seg, s = edge_case(d, dtype, d)
    want = plain_with_zero_rows(table, idx, seg, s)
    cuda = table.to(dev)
    assert er.copy_bytes(cuda) == COPY_BYTES[(dtype, d)]
    er.reset_launches()
    got = er.embedding_reduce(cuda, idx.to(dev), seg.to(dev), s)
    torch.cuda.synchronize()
    assert er.launches["embedding_reduce"] == 1
    _same(want, got, "embedding_reduce")
    assert bool(torch.signbit(got[8]).all())


def test_embedding_reduce_unaligned_table_takes_4_byte_copies(dev):
    """A table that starts 4 bytes into its storage cannot take 16-byte
    copies; the 4-byte walk gives the same sums."""
    table, idx, seg, s = edge_case(11, torch.float32, 64)
    flat = torch.zeros(table.numel() + 1, device=dev)
    view = flat[1:].view(table.shape)
    view.copy_(table)
    assert er.copy_bytes(view) == 4
    got = er.embedding_reduce(view, idx.to(dev), seg.to(dev), s)
    torch.cuda.synchronize()
    _same(plain_with_zero_rows(table, idx, seg, s), got, "embedding_reduce")


def test_embedding_reduce_table_past_4_gib(dev):
    """A (2^24 + 4,096, 64) f32 table, 4.3 GB: rows whose byte offsets pass
    2^31 and 2^32 sum like the plain version's on the card."""
    rows, d = 2**24 + 4096, 64
    g = torch.Generator(device=dev).manual_seed(5)
    table = torch.randn((rows, d), generator=g, device=dev)
    idx = torch.cat([
        torch.randint(0, rows, (2000,), generator=g, device=dev),
        torch.randint(rows - 2**23, rows, (2000,), generator=g, device=dev),
        torch.tensor([rows - 1, 2**23, 2**24, 2**24 + 4095], device=dev),
    ]).to(torch.int32)
    seg = torch.sort(torch.randint(0, 300, idx.shape, generator=g,
                                   device=dev)).values.to(torch.int32)
    want = ref.embedding_reduce(table, idx, seg, 300)
    got = er.embedding_reduce(table, idx, seg, 300)
    torch.cuda.synchronize()
    _same(want, got, "embedding_reduce")


def test_dlrm_embedding_path_matches_plain_on_the_card(dev):
    cfg = dlrm.DLRMConfig(num_tables=4, rows=128, dim=64, lookups=16)
    params = dlrm.init_params(cfg, torch.Generator().manual_seed(1),
                              device=dev)
    idx = torch.randint(0, cfg.rows, (33, 4, 16), dtype=torch.int32,
                        device=dev)
    want = dlrm.embedding_reduce(params["tables"], idx, backend="ref")
    er.reset_launches()
    got = dlrm.embedding_reduce(params["tables"], idx, backend="auto")
    torch.cuda.synchronize()
    assert er.launches["embedding_reduce"] == 1
    _same(want, got, "dlrm embedding_reduce")


def _engine_pair(app_step, app_cfg, make_state, w, inject_fn, rounds=10):
    runs = {}
    for backend in ("auto", "ref"):
        ecfg = eng.EngineConfig(num_queues=4, capacity=16, req_words=w,
                                resp_words=w, budget=8,
                                kernel_backend=backend)
        state = eng.make(ecfg, make_state())
        app = eng.bind_app(app_step, app_cfg, ecfg)
        rng = np.random.default_rng(7)
        tc.reset_launches()
        er.reset_launches()
        out = []
        for _ in range(rounds):
            state = eng.inject(state, torch.arange(4), inject_fn(rng))
            state, stats = eng.run_steps(state, app, ecfg, 2)
            pay, counts, state = eng.drain_responses(state, 16)
            out.append((stats, pay, counts))
        torch.cuda.synchronize()
        runs[backend] = (interop.to_numpy((state, out)),
                         {**tc.launches, **er.launches})
    return runs


def test_engine_tx_kernels_equal_plain_on_the_card(dev):
    cfg = tx.TxConfig(num_keys=64, val_words=4, max_ops=3, chain_len=3,
                      log_capacity=16)
    w = tx_app.request_words(cfg)

    def inject(rng):
        pl = np.zeros((4, w), np.int32)
        pl[:, 0] = rng.integers(0, cfg.max_ops + 2, 4)  # some MALFORMED
        ops = pl[:, 1:].reshape(4, cfg.max_ops, 1 + cfg.val_words)
        ops[..., 0] = rng.integers(0, 8, (4, cfg.max_ops))
        ops[..., 1:] = rng.integers(-99, 99, (4, cfg.max_ops, cfg.val_words))
        pl[:, 1:] = ops.reshape(4, -1)
        return torch.from_numpy(pl)

    runs = _engine_pair(tx_app.app_step, cfg,
                        lambda: tx.make_chain(cfg, device=dev), w, inject)
    (a, launches), (b, plain) = runs["auto"], runs["ref"]
    for x, y in zip(_flat(a), _flat(b), strict=True):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert launches["commit_chain"] > 0, launches
    assert not any(plain.values())


def test_engine_dlrm_kernels_equal_plain_on_the_card(dev):
    cfg = dlrm.DLRMConfig(num_tables=3, rows=64, dim=16, lookups=8,
                          dense_features=5)
    params = dlrm.init_params(cfg, torch.Generator().manual_seed(2),
                              device=dev)
    w = dlrm.request_words(cfg)

    def inject(rng):
        dense, idx = dlrm.gen_queries(cfg, 4, None, 0.0, rng)
        pl = np.zeros((4, w), np.int32)
        pl[:, 0] = rng.choice([0, 1, 1, 3], 4)
        pl[:, 1: 1 + cfg.dense_features] = dense.view(np.int32)
        pl[:, 1 + cfg.dense_features:] = idx.reshape(4, -1)
        return torch.from_numpy(pl)

    runs = _engine_pair(dlrm.app_step, cfg, lambda: params, w, inject)
    (a, launches), (b, plain) = runs["auto"], runs["ref"]
    for x, y in zip(_flat(a), _flat(b), strict=True):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert launches["embedding_reduce"] > 0, launches
    assert not any(plain.values())


# ------------------------------ LM serving ----------------------------------

LM_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def _paged_case(rng, dev, dtype, b, kvh, g, hd, ps, maxp, lengths):
    npages = b * maxp + 2
    q = torch.from_numpy((rng.normal(size=(b, kvh, g, hd)) * hd ** -0.5)
                         .astype(np.float32))
    kp = torch.from_numpy(rng.normal(size=(npages, ps, kvh, hd))
                          .astype(np.float32)).to(dtype)
    vp = torch.from_numpy(rng.normal(size=(npages, ps, kvh, hd))
                          .astype(np.float32)).to(dtype)
    kp[-1] = 0
    vp[-1] = 0  # the zero sentinel
    pt = rng.permutation(npages - 1)[: b * maxp].reshape(b, maxp)
    pt[-1, 0] = -1  # unmapped inside the length: reads the sentinel
    pt[0, -1] = -1
    args = (q, kp, vp, torch.from_numpy(pt.astype(np.int32)),
            torch.as_tensor(lengths, dtype=torch.int32))
    return args, tuple(a.to(dev) for a in args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kvh,g,hd,ps,maxp", [
    (2, 1, 16, 4, 3), (2, 4, 16, 8, 5), (1, 2, 8, 16, 2), (8, 5, 128, 16, 40),
    (2, 5, 64, 16, 137),
])
def test_paged_attention_stats_matches_plain_version(dev, dtype, kvh, g, hd,
                                                     ps, maxp):
    """(acc, m, l) against the plain version: zero length, full, ragged,
    -1 entries, G up to 5, the serve head geometry; 2,192 table tokens
    (two splits of 1,096, a boundary inside a page, MaxP odd), where the
    short rows leave the second split empty."""
    rng = np.random.default_rng(hd + ps)
    full = ps * maxp
    lengths = [0, full, full - 3, 1, 33 if full > 33 else full]
    host, cuda = _paged_case(rng, dev, dtype, len(lengths), kvh, g, hd, ps,
                             maxp, lengths)
    want = ref.paged_attention_stats(*host)
    pa.reset_launches()
    got = pa.paged_attention_stats(*cuda)
    torch.cuda.synchronize()
    assert pa.launches["paged_attention_stats"] == 1
    tol = LM_TOL[dtype]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)
    assert float(got[0][0].abs().max()) == 0.0
    assert bool((got[1][0] == -1e30).all()) and bool((got[2][0] == 0).all())


def test_paged_attention_stats_long_table_matches_plain_version(dev):
    """A 4,096-token table on a bf16 pool (two splits of 2,048; the short
    rows leave the second empty), the serve head geometry. In f32 the
    kernel and the plain version sum 4,096 terms in two orders and part
    ways by up to about 2e-5, past the 1e-5 tolerance, so this length is
    held in bf16 only."""
    rng = np.random.default_rng(4096)
    maxp, ps = 256, 16
    full = ps * maxp
    lengths = [0, full, full - 3, 1, 33, full // 2 + 5]
    host, cuda = _paged_case(rng, dev, torch.bfloat16, len(lengths), 8, 5,
                             128, ps, maxp, lengths)
    assert pa.splits(maxp, ps) == 2
    want = ref.paged_attention_stats(*host)
    pa.reset_launches()
    got = pa.paged_attention_stats(*cuda)
    torch.cuda.synchronize()
    assert pa.launches["paged_attention_stats"] == 1
    tol = LM_TOL[torch.bfloat16]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)
    assert float(got[0][0].abs().max()) == 0.0
    assert bool((got[1][0] == -1e30).all()) and bool((got[2][0] == 0).all())


def _stats_f64(q, k_pages, v_pages, page_table, lengths):
    """The plain version's (acc, m, l) in float64; an empty row has the
    f32 kernel's m of -1e30."""
    b, kvh, g, hd = q.shape
    np_, ps = k_pages.shape[0], k_pages.shape[1]
    maxp = page_table.shape[1]
    pt = torch.where(page_table < 0, np_ - 1, page_table).long()
    kk = k_pages[pt].reshape(b, maxp * ps, kvh, hd).double()
    vv = v_pages[pt].reshape(b, maxp * ps, kvh, hd).double()
    s = torch.einsum("bkgh,bskh->bkgs", q.double(), kk)
    valid = (torch.arange(maxp * ps)[None, :]
             < lengths[:, None])[:, None, None, :]
    s = torch.where(valid, s, -torch.inf)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    empty = torch.tensor(-1e30, dtype=torch.float32).double()
    m = torch.where(valid.any(dim=-1), m, empty)
    return torch.einsum("bkgs,bskh->bkgh", p, vv), m, p.sum(dim=-1)


def test_paged_attention_stats_f32_long_table_against_float64(dev):
    """The 4,096-token case on an f32 pool, where kernel and plain version
    part by more than the 1e-5 tolerance: both are held against a float64
    plain version instead, and each output's largest error in the kernel
    may be at most twice the f32 plain version's. Both sum the same 4,096
    terms in f32 in other orders (the kernel by 32-token chunks with
    online rescaling and two splits merged), so neither is the more
    accurate by construction and the kernel's error may fall on either
    side of the plain version's; 2 leaves room for that, while a dropped,
    doubled or wrongly rescaled chunk would be off by orders of
    magnitude."""
    rng = np.random.default_rng(4096)
    maxp, ps = 256, 16
    full = ps * maxp
    lengths = [0, full, full - 3, 1, 33, full // 2 + 5]
    host, cuda = _paged_case(rng, dev, torch.float32, len(lengths), 8, 5,
                             128, ps, maxp, lengths)
    assert pa.splits(maxp, ps) == 2
    plain = ref.paged_attention_stats(*host)
    exact = _stats_f64(*host)
    pa.reset_launches()
    got = pa.paged_attention_stats(*cuda)
    torch.cuda.synchronize()
    assert pa.launches["paged_attention_stats"] == 1
    for name, k, p, x in zip(("acc", "m", "l"), got, plain, exact):
        err_kernel = float((k.cpu().double() - x).abs().max())
        err_plain = float((p.double() - x).abs().max())
        assert err_kernel <= 2 * err_plain, (name, err_kernel, err_plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kvh,g,hd,ps,maxp,split_tokens", [
    (2, 5, 64, 16, 9, 16), (2, 3, 16, 4, 7, 4), (8, 5, 128, 16, 40, 96),
    (2, 2, 128, 8, 11, 12),
])
def test_paged_attention_stats_splits_match_plain_version(
        dev, monkeypatch, dtype, kvh, g, hd, ps, maxp, split_tokens):
    """Short tables cut into many splits (SPLIT_TOKENS lowered): up to 8
    CTAs per cluster, ranges that end inside pages, MaxP not a multiple
    of S, and rows whose length leaves later splits empty, all merged
    across the cluster to the plain version's (acc, m, l)."""
    monkeypatch.setattr(pa, "SPLIT_TOKENS", split_tokens)
    assert pa.splits(maxp, ps) > 1
    rng = np.random.default_rng(hd + maxp)
    full = ps * maxp
    lengths = [0, full, full - 3, 1, ps + 1, full // 2]
    host, cuda = _paged_case(rng, dev, dtype, len(lengths), kvh, g, hd, ps,
                             maxp, lengths)
    want = ref.paged_attention_stats(*host)
    pa.reset_launches()
    got = pa.paged_attention_stats(*cuda)
    torch.cuda.synchronize()
    assert pa.launches["paged_attention_stats"] == 1
    tol = LM_TOL[dtype]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)
    assert float(got[0][0].abs().max()) == 0.0
    assert bool((got[1][0] == -1e30).all()) and bool((got[2][0] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,window,g,hd", [
    (64, 0, 1, 8), (64, 0, 2, 16), (128, 48, 4, 8), (32, 8, 1, 8),
    (100, 0, 5, 128), (256, 128, 5, 128), (40, 0, 2, 256),
    (130, 0, 2, 64), (192, 70, 1, 64), (512, 0, 5, 128),
    (1, 0, 5, 128), (2048, 0, 2, 128), (2048, 128, 1, 64),
])
def test_flash_attention_matches_plain_version(dev, dtype, s, window, g, hd):
    """Causal GQA attention against the plain version: windows, ragged S
    (not a multiple of the tiles), head dims 8 to 256, both kernel paths
    (tensor cores for bf16 at hd 64 and 128, FMAs otherwise)."""
    rng = np.random.default_rng(s + hd)
    b, kvh = 2, 2
    h = kvh * g
    host = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(dtype) for shape in ((b, h, s, hd), (b, kvh, s, hd),
                                     (b, kvh, s, hd))]
    want = ref.flash_attention(*host, window=window)
    fa.reset_launches()
    got = fa.flash_attention(*(t.to(dev) for t in host), window=window)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 1 and got.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else LM_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_takes_strided_views(dev, dtype, hd):
    """(B, S, H, hd) tensors passed as their (B, H, S, hd) views give the
    kernel output of contiguous copies, bit for bit, and the output is a
    (B, H, S, hd) view of a (B, S, H, hd) tensor."""
    rng = np.random.default_rng(hd)
    b, h, kvh, s = 2, 10, 2, 200
    bshd = [torch.from_numpy(rng.normal(size=(b, s, n, hd))
                             .astype(np.float32)).to(dtype).to(dev)
            for n in (h, kvh, kvh)]
    views = [t.transpose(1, 2) for t in bshd]
    fa.reset_launches()
    got = fa.flash_attention(*views, window=64)
    want = fa.flash_attention(*(t.contiguous() for t in views), window=64)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 2
    assert torch.equal(got, want)
    assert got.shape == (b, h, s, hd) and got.transpose(1, 2).is_contiguous()


def test_lm_wrappers_reject_bad_tensors(dev):
    q = torch.zeros((2, 2, 2, 8), device=dev)
    pages = torch.zeros((3, 4, 2, 8), device=dev)
    pt = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    ln = torch.zeros((2,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        pa.paged_attention_stats(q.cpu(), pages, pages, pt, ln)
    with pytest.raises(TypeError):
        pa.paged_attention_stats(q.to(torch.bfloat16), pages, pages, pt, ln)
    with pytest.raises(ValueError):
        pa.paged_attention_stats(q, pages[:, :, :1], pages, pt, ln)
    q12 = torch.zeros((2, 2, 2, 12), device=dev)
    p12 = torch.zeros((3, 4, 2, 12), device=dev)
    with pytest.raises(ValueError):  # hd not a multiple of 8
        pa.paged_attention_stats(q12, p12, p12, pt, ln)
    x = torch.zeros((1, 4, 16, 8), device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(x, x[:, :3], x[:, :3])
    with pytest.raises(TypeError):
        fa.flash_attention(x, x.to(torch.bfloat16), x)
    wide = torch.zeros((1, 4, 16, 16), device=dev)
    with pytest.raises(ValueError):  # a non-unit last stride
        fa.flash_attention(wide[..., ::2], wide[..., ::2], wide[..., ::2])


def test_lm_engine_kernels_equal_plain_on_the_card(dev):
    """The paged LM engine with the kernels (auto) and with the plain
    versions (ref) on the card, f32, flash prefill on: equal token
    streams, pools within 1e-5, both kernels launched."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import local_context

    cfg = reduced(get_config("qwen2.5-14b")).replace(
        dtype="float32", use_pallas_flash=True, flash_block=8)
    ctx = local_context()
    params = init_params(0, cfg, ctx, dev)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (8, 8)).astype(np.int32))
    out = {}
    for backend in ("auto", "ref"):
        ecfg = eng.LMEngineConfig(num_queues=4, capacity=8, prompt_len=8,
                                  gen_len=6, slots=4, admit_per_step=2,
                                  paged=True, page_size=4,
                                  kernel_backend=backend)
        state = eng.lm_make_paged(ecfg, cfg, ctx, dev)
        pa.reset_launches()
        fa.reset_launches()
        for i in range(0, 8, 4):
            state = eng.lm_inject(state, torch.arange(4), prompts[i:i + 4])
            for _ in range(10):
                state = eng.lm_engine_step(state, ecfg, cfg, ctx, params)
        torch.cuda.synchronize()
        out[backend] = (state, pa.launches["paged_attention_stats"],
                        fa.launches["flash_attention"])
    (a, pl, fl), (b, pl_ref, fl_ref) = out["auto"], out["ref"]
    assert pl > 0 and fl > 0 and pl_ref == fl_ref == 0
    assert int(a.completed) == int(b.completed) == 8
    assert torch.equal(a.resp.entries, b.resp.entries)
    torch.testing.assert_close(a.decode.k_pages, b.decode.k_pages,
                               rtol=1e-5, atol=1e-5)


# ------------------------------ MoE serving ---------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"


def test_attention_kernels_at_the_moe_serve_shapes(dev):
    """Both attention kernels at Qwen3-MoE-30B-A3B's serve shapes, bf16:
    the paged walk at B = 32, KVH = 4, G = 8 (= MAX_GROUP, a warp a query
    row) on 40-page tables of 16-token pages, and the flash prefill at
    B = 8, H = 32, KVH = 4, S = 512, hd 128."""
    assert pa.MAX_GROUP == 8
    rng = np.random.default_rng(32)
    maxp, ps = 40, 16
    lengths = rng.integers(512, maxp * ps, 32)
    lengths[:3] = (0, maxp * ps, 1)
    host, cuda = _paged_case(rng, dev, torch.bfloat16, 32, 4, 8, 128, ps,
                             maxp, lengths)
    want = ref.paged_attention_stats(*host)
    pa.reset_launches()
    got = pa.paged_attention_stats(*cuda)
    torch.cuda.synchronize()
    assert pa.launches["paged_attention_stats"] == 1
    tol = LM_TOL[torch.bfloat16]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)
    host = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(torch.bfloat16) for shape in ((8, 32, 512, 128),
                                              (8, 4, 512, 128),
                                              (8, 4, 512, 128))]
    want = ref.flash_attention(*host)
    fa.reset_launches()
    got = fa.flash_attention(*(t.to(dev) for t in host))
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 1
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


def test_moe_apply_on_the_card_matches_the_cpu(dev, monkeypatch):
    """One Qwen3-MoE-30B-A3B layer's experts at full width (128 experts,
    top 8, d 2048, expert ff 768, bf16, f32 router), 128 tokens (a
    capacity of 16 an expert): the card's ``moe_apply`` against the same
    call on the CPU,
    routes equal where the 8th and 9th gates are apart, outputs within the
    bf16 tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator().manual_seed(0)
    params = moe.moe_init(gen, cfg, "cpu")
    x = torch.randn((2, 64, cfg.d_model), generator=gen).to(torch.bfloat16)
    gp = {k: v.to(dev) for k, v in params.items()}
    want, want_aux = moe.moe_apply(params, x, cfg)
    got, got_aux = moe.moe_apply(gp, x.to(dev), cfg)
    _, ids_c, _ = moe._route(params, x.reshape(-1, cfg.d_model), cfg)
    _, ids_g, _ = moe._route(gp, x.to(dev).reshape(-1, cfg.d_model), cfg)
    gates = torch.softmax(x.reshape(-1, cfg.d_model).float()
                          @ params["router"], dim=-1)
    top = gates.sort(dim=-1, descending=True).values
    k = cfg.num_experts_per_tok
    clear = (top[:, k - 1] - top[:, k]) > 1e-5
    assert int(clear.sum()) > 100
    assert torch.equal(ids_g.cpu()[clear], ids_c[clear])
    tol = LM_TOL[torch.bfloat16]
    rows = clear.reshape(2, 64)
    torch.testing.assert_close(got.cpu().float()[rows], want.float()[rows],
                               rtol=tol, atol=tol)
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=1e-5, atol=1e-5)


def _moe_prefill_and_decode(cfg, ctx, params, toks, dev, steps=4):
    """prefill_kv into a fresh pool, then ``steps`` greedy paged decode
    steps through the kernels; returns every logit and the pools."""
    from repro_torch.models import model
    from repro_torch.serving import kv_cache as pk

    pcfg = model.make_paged_kv_config(cfg, ctx, num_pages=32, page_size=16,
                                      max_pages_per_seq=8)
    kv = pk.make(pcfg, toks.shape[0], torch.bfloat16, dev)
    k, v, logits = model.prefill_kv(params, toks, cfg, ctx,
                                    kernel_backend="cuda")
    slots = torch.arange(toks.shape[0], dtype=torch.int32, device=dev)
    kv, _ = pk.prefill_into_pages(kv, pcfg, slots, k, v,
                                  torch.ones_like(slots, dtype=torch.bool))
    outs = [logits]
    nxt = logits.argmax(-1).to(torch.int32)
    for _ in range(steps):
        kv, logits, _ = model.paged_decode_step(params, nxt, kv, pcfg, cfg,
                                                ctx, kernel_backend="cuda")
        outs.append(logits)
        nxt = logits.argmax(-1).to(torch.int32)
    return outs, kv


def test_moe_prefill_and_decode_are_bit_reproducible(dev):
    """Qwen3-MoE-30B-A3B at full width cut to 2 layers, bf16, flash
    prefill (2 prompts of 64 tokens, with drops) and 4 paged decode steps
    through both kernels, twice from the same inputs: every logit and the
    pools equal bit for bit (the combine adds the k expert outputs in
    order, never by atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import local_context

    cfg = get_config(MOE_ARCH).replace(num_layers=2, use_pallas_flash=True,
                                       flash_block=64)
    ctx = local_context()
    params = init_params(0, cfg, ctx, dev)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (2, 64)).astype(np.int32)).to(dev)
    pa.reset_launches()
    fa.reset_launches()
    first, kv1 = _moe_prefill_and_decode(cfg, ctx, params, toks, dev)
    second, kv2 = _moe_prefill_and_decode(cfg, ctx, params, toks, dev)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 2 * cfg.num_layers
    assert pa.launches["paged_attention_stats"] == 2 * 4 * cfg.num_layers
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(kv1.k_pages, kv2.k_pages)
    assert torch.equal(kv1.v_pages, kv2.v_pages)


def test_lm_moe_engine_kernels_equal_plain_on_the_card(dev):
    """The paged LM engine serving reduced Qwen3-MoE-30B-A3B (f32, flash
    prefill on, capacity factor 0.5 so prefill drops) with the kernels
    and with the plain versions on the card: equal token streams, pools
    within 1e-5, both kernels launched."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import local_context

    cfg = reduced(get_config(MOE_ARCH)).replace(
        dtype="float32", use_pallas_flash=True, flash_block=8,
        capacity_factor=0.5)
    ctx = local_context()
    params = init_params(0, cfg, ctx, dev)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (8, 16)).astype(np.int32))
    out = {}
    for backend in ("auto", "ref"):
        ecfg = eng.LMEngineConfig(num_queues=4, capacity=8, prompt_len=16,
                                  gen_len=6, slots=4, admit_per_step=2,
                                  paged=True, page_size=4,
                                  kernel_backend=backend)
        state = eng.lm_make_paged(ecfg, cfg, ctx, dev)
        pa.reset_launches()
        fa.reset_launches()
        for i in range(0, 8, 4):
            state = eng.lm_inject(state, torch.arange(4), prompts[i:i + 4])
            for _ in range(10):
                state = eng.lm_engine_step(state, ecfg, cfg, ctx, params)
        torch.cuda.synchronize()
        out[backend] = (state, pa.launches["paged_attention_stats"],
                        fa.launches["flash_attention"])
    (a, pl, fl), (b, pl_ref, fl_ref) = out["auto"], out["ref"]
    assert pl > 0 and fl > 0 and pl_ref == fl_ref == 0
    assert int(a.completed) == int(b.completed) == 8
    assert torch.equal(a.resp.entries, b.resp.entries)
    torch.testing.assert_close(a.decode.k_pages, b.decode.k_pages,
                               rtol=1e-5, atol=1e-5)


# ------------------------- fault and durability ------------------------------

def _failed_over_chain(dev, rng, cfg, batches_live=3, batches_dead=6):
    """A chain on ``dev`` whose replica 1 died after ``batches_live``
    batches and missed the next ``batches_dead`` (its log fell behind)."""
    chain = tx.make_chain(cfg, dev)
    for i in range(batches_live + batches_dead):
        if i == batches_live:
            live = chain.live.clone()
            live[1] = False
            chain = chain._replace(live=live)
        plan = _tx_plan(rng, cfg, 8, dev)
        chain = tx.chain_commit_apply(chain, plan, kernel_backend="ref")
    return chain


def test_resync_through_the_commit_kernel_equals_plain(dev):
    """resync_replica replays a revived replica's gap with one commit
    launch per record; the kernel path and the plain path give the same
    chain, bit for bit."""
    from repro_torch.fault import chain as fchain

    cfg = tx.TxConfig(num_keys=64, val_words=4, max_ops=3, chain_len=3,
                      log_capacity=256)
    chain = _failed_over_chain(dev, np.random.default_rng(1), cfg)
    gap = int(chain.log_tail[0]) - int(chain.log_tail[1])
    assert 0 < gap <= cfg.log_capacity
    out = {}
    for backend in ("cuda", "ref"):
        copy = tx.ReplicaState(*(x.clone() for x in chain))
        tc.reset_launches()
        out[backend] = fchain.resync_replica(copy, cfg, 1,
                                             kernel_backend=backend)
        torch.cuda.synchronize()
        launches = dict(tc.launches)
        assert launches["commit"] == (gap if backend == "cuda" else 0)
    _same(out["ref"], out["cuda"], "resync cuda vs ref")
    assert bool(out["cuda"].live.all())
    for f in ("store", "log", "log_tail", "committed"):
        assert torch.equal(getattr(out["cuda"], f)[1],
                           getattr(out["cuda"], f)[0]), f


def test_recover_through_the_commit_kernel_equals_plain(dev, tmp_path):
    """A TX engine's snapshot + WAL deltas recovered on the card: the
    replay launches the commit kernel once per redo record and gives the
    state the plain replay gives, which is the live state at the flush."""
    from repro_torch.checkpoint import checkpointer
    from repro_torch.fault import recovery as frec

    cfg = tx.TxConfig(num_keys=64, val_words=4, max_ops=3, chain_len=3,
                      log_capacity=256)
    w = tx_app.request_words(cfg)
    ecfg = eng.EngineConfig(num_queues=4, capacity=16, req_words=w,
                            resp_words=w, budget=8, kernel_backend="cuda")
    app = eng.bind_app(tx_app.app_step, cfg, ecfg)
    state = eng.make(ecfg, tx.make_chain(cfg, dev))
    mgr = frec.DurabilityManager(frec.DurabilityConfig(
        str(tmp_path), mode="delta", snapshot_every=1000, group_records=2))
    rng = np.random.default_rng(2)
    for step in range(8):
        pays = np.zeros((4, w), np.int32)
        pays[:, 0] = rng.integers(1, cfg.max_ops + 1, 4)
        ops = pays[:, 1:].reshape(4, cfg.max_ops, 1 + cfg.val_words)
        ops[..., 0] = rng.integers(0, cfg.num_keys, (4, cfg.max_ops))
        ops[..., 1:] = rng.integers(1, 999, (4, cfg.max_ops, cfg.val_words))
        pays[:, 1:] = ops.reshape(4, -1)
        state = eng.inject(state, np.arange(4, dtype=np.int32), pays)
        state, _ = eng.engine_step(state, app, ecfg)
        mgr.flush(state)
        flushed = checkpointer.host_copy(state)
        _, _, state = eng.drain_responses(state, ecfg.capacity)
    mgr.wait()
    out = {}
    for backend in ("cuda", "ref"):
        like = eng.make(ecfg, tx.make_chain(cfg, dev))
        stats = {}
        tc.reset_launches()
        out[backend], covered = frec.recover(str(tmp_path), like,
                                             kernel_backend=backend,
                                             stats=stats)
        torch.cuda.synchronize()
        assert covered == 8 and stats["tx_records"] > 0
        assert tc.launches["commit"] == (
            stats["tx_records"] if backend == "cuda" else 0)
    _same(out["ref"], out["cuda"], "recover cuda vs ref")
    _same(flushed, out["cuda"], "recovered vs the last flush")


# -------------------- vlm, hybrid, ssm and audio serving --------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,s,window", [
    (25, 5, 2048, 1024),  # hymba-1.5b: hd 64, G 5, the window bites
    (32, 32, 512, 0),  # musicgen-large: hd 64, G 1
    (28, 4, 512, 0),  # qwen2-vl-7b: hd 128, G 7
])
def test_flash_attention_at_the_family_serve_shapes(dev, dtype, h, kvh, s,
                                                    window):
    """The flash prefill at the new families' head geometries against the
    plain version (one prompt): in bf16 the TMA/wgmma path at hd 64 with
    a window of 1,024 and at G 1; in f32 the CUDA-core path."""
    hd = 64 if h in (25, 32) else 128
    rng = np.random.default_rng(h + s + window)
    host = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(dtype) for shape in ((1, h, s, hd), (1, kvh, s, hd),
                                     (1, kvh, s, hd))]
    want = ref.flash_attention(*host, window=window)
    fa.reset_launches()
    got = fa.flash_attention(*(t.to(dev) for t in host), window=window)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 1
    tol = 2e-5 if dtype == torch.float32 else LM_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh", [(20, 4), (16, 2)])
def test_flash_attention_at_the_tensor_parallel_rank_shapes(dev, dtype, h,
                                                            kvh):
    """The flash prefill at one of two tensor-parallel ranks' heads:
    qwen2.5-14b's 40 q / 8 kv as 20 / 4 (G 5), qwen3-moe's 32 / 4 as
    16 / 2 (G 8); hd 128, 512 tokens, two prompts."""
    rng = np.random.default_rng(h + kvh)
    host = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(dtype) for shape in ((2, h, 512, 128), (2, kvh, 512, 128),
                                     (2, kvh, 512, 128))]
    want = ref.flash_attention(*host)
    fa.reset_launches()
    got = fa.flash_attention(*(t.to(dev) for t in host))
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 1
    tol = 2e-5 if dtype == torch.float32 else LM_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


def test_tensor_parallel_decode_on_two_ranks_equals_one_process(dev):
    """prefill and greedy decode steps of a small bf16 dense model on 2
    model ranks sharing the card (gloo, host-staged) against the same
    params in one process on the card: each step's logits within the bf16
    kernel tolerance of the largest |logit| (the row-split products sum
    in another order), the ranks' logits equal bit for bit, and each rank
    launched flash once a layer of the prefill at its 4 q / 2 kv heads."""
    import torch_tp_ranks as tpr
    from repro_torch.models import model
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import local_context

    cfg = tpr.cuda_tp_config()
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, cfg.vocab_size, tpr.CUDA_PROMPTS).astype(
        np.int32)
    with torch.no_grad():
        ctx = local_context()
        want = tpr.cuda_decode(model.init_params(3, cfg, ctx, "cuda"), cfg,
                               ctx, torch.from_numpy(prompts).cuda())
    out = coll.launch(tpr.cuda_decode_rank, 2, backend="gloo",
                      args=(prompts,), timeout=300)
    for logits, launches in out:
        assert launches == {"flash_attention": cfg.num_layers}, launches
        for a, b in zip(logits, want):
            b = b.float().numpy()
            assert np.abs(a - b).max() <= LM_TOL[torch.bfloat16] \
                * np.abs(b).max()
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,s,hd,window", [
    (14, 2, 512, 128, 0),  # qwen2-vl-7b's 28 q / 4 kv a rank: G 7
    (15, 3, 2048, 64, 1024),  # hymba-1.5b's 25 / 5 padded to 30 / 6
    (16, 16, 512, 64, 0),  # musicgen-large's 32 / 32: G 1
])
def test_flash_attention_at_the_tensor_parallel_family_rank_shapes(
        dev, dtype, h, kvh, s, hd, window):
    """The flash prefill at one of two tensor-parallel ranks' heads of the
    vlm, hybrid (hd 64 with its window: the TMA path) and audio families,
    two prompts, against the plain version."""
    rng = np.random.default_rng(h + kvh + s)
    host = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(dtype) for shape in ((2, h, s, hd), (2, kvh, s, hd),
                                     (2, kvh, s, hd))]
    want = ref.flash_attention(*host, window=window)
    fa.reset_launches()
    got = fa.flash_attention(*(t.to(dev) for t in host), window=window)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 1
    tol = 2e-5 if dtype == torch.float32 else LM_TOL[dtype]
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


def test_data_parallel_paged_decode_on_two_ranks_equals_one_process(dev):
    """The paged path of the engine over 2 data ranks sharing the card
    (gloo, host-staged): every rank prefills the whole batch and writes
    its rows' pages, then walks its rows with ``paged_attention_stats``;
    each rank's logits are its rows of the one-process run on the card
    within the bf16 kernel tolerance of the largest |logit|, and each
    rank launched flash once a layer and the walk once a layer a step."""
    import torch_dp_engine_ranks as dpr
    import torch_tp_ranks as tpr
    from repro_torch.models import model
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import local_context

    cfg = tpr.cuda_tp_config()
    rng = np.random.default_rng(6)
    prompts = rng.integers(1, cfg.vocab_size, dpr.CUDA_PROMPTS).astype(
        np.int32)
    with torch.no_grad():
        ctx = local_context()
        want = dpr.cuda_paged_decode(model.init_params(3, cfg, ctx, "cuda"),
                                     cfg, ctx, torch.from_numpy(prompts).cuda())
    out = coll.launch(dpr.cuda_dp_paged_rank, 2, backend="gloo",
                      args=(prompts,), timeout=300)
    seen = []
    for logits, launches, (lo, hi) in out:
        assert launches == {"flash_attention": cfg.num_layers,
                            "paged_attention_stats":
                                cfg.num_layers * dpr.CUDA_STEPS}, launches
        for a, b in zip(logits, want):
            b = b.float().numpy()[lo:hi]
            assert np.abs(a - b).max() <= LM_TOL[torch.bfloat16] \
                * np.abs(b).max()
        seen += range(lo, hi)
    assert seen == list(range(dpr.CUDA_PROMPTS[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_stats_at_the_vlm_serve_shape(dev, dtype):
    """The paged walk at qwen2-vl-7b's decode shape: B 32, KVH 4, G 7,
    hd 128, 40-page tables of 16-token pages."""
    rng = np.random.default_rng(7)
    maxp, ps = 40, 16
    lengths = rng.integers(512, maxp * ps, 32)
    lengths[:3] = (0, maxp * ps, 1)
    host, cuda = _paged_case(rng, dev, dtype, 32, 4, 7, 128, ps, maxp,
                             lengths)
    want = ref.paged_attention_stats(*host)
    pa.reset_launches()
    got = pa.paged_attention_stats(*cuda)
    torch.cuda.synchronize()
    assert pa.launches["paged_attention_stats"] == 1
    tol = LM_TOL[dtype]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kvh,g", [(4, 5), (2, 8)])
def test_paged_attention_stats_at_the_tensor_parallel_rank_shapes(
        dev, dtype, kvh, g):
    """The paged walk at one of two tensor-parallel ranks' decode shapes,
    B 32, hd 128, 40-page tables of 16-token pages: Qwen2.5-14B's 4 kv
    heads of G 5 and Qwen3-MoE-30B-A3B's 2 kv heads of G 8 (the kernel's
    largest group)."""
    rng = np.random.default_rng(kvh * 10 + g)
    maxp, ps = 40, 16
    lengths = rng.integers(512, maxp * ps, 32)
    lengths[:3] = (0, maxp * ps, 1)
    host, cuda = _paged_case(rng, dev, dtype, 32, kvh, g, 128, ps, maxp,
                             lengths)
    want = ref.paged_attention_stats(*host)
    pa.reset_launches()
    got = pa.paged_attention_stats(*cuda)
    torch.cuda.synchronize()
    assert pa.launches["paged_attention_stats"] == 1
    tol = LM_TOL[dtype]
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol)


@pytest.mark.parametrize("inclusive", [False, True])
def test_chunked_gla_on_the_card_matches_the_cpu(dev, inclusive,
                                                 monkeypatch):
    """The chunked GLA engine in f32 (TF32 off) at rwkv6-1.6b's head shape
    (32 heads of 64) and hymba's Mamba shape (50 heads, state 16, hd 64),
    300 tokens with a carried state: the card against the CPU, outputs and
    final state each within 1e-5 of their largest |value| (the two
    devices sum the chunk products in other orders; the outputs reach
    about 100)."""
    from repro_torch.models import ssm

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    h, dk, dv = (50, 16, 64) if inclusive else (32, 64, 64)
    gen = torch.Generator().manual_seed(3)
    q, k = torch.randn((2, 2, 300, h, dk), generator=gen)
    v = torch.randn((2, 300, h, dv), generator=gen)
    logw = -torch.rand((2, 300, h, dk), generator=gen) * 2
    u = None if inclusive else torch.randn((h, dk), generator=gen) * 0.1
    st = torch.randn((2, h, dk, dv), generator=gen)
    want = ssm.chunked_gla(q, k, v, logw, u, chunk=32, state=st)
    got = ssm.chunked_gla(*(t.to(dev) for t in (q, k, v, logw)),
                          None if u is None else u.to(dev), chunk=32,
                          state=st.to(dev))
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(
            b.abs().max())


def test_mamba_apply_on_the_card_matches_the_cpu(dev, monkeypatch):
    """One hymba-1.5b Mamba branch at full width (d 1600, din 3200, state
    16), f32, TF32 off, 2 x 200 tokens: the card against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = get_config("hymba-1.5b").replace(dtype="float32")
    gen = torch.Generator().manual_seed(4)
    params = ssm.mamba_init(gen, cfg, "cpu")
    x = torch.randn((2, 200, cfg.d_model), generator=gen)
    want = ssm.mamba_apply(params, x, cfg)
    on_card = {k: ({n: t.to(dev) for n, t in v.items()}
                   if isinstance(v, dict) else v.to(dev))
               for k, v in params.items()}
    got = ssm.mamba_apply(on_card, x.to(dev), cfg)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def _hybrid_prefill_and_decode(cfg, ctx, params, toks, dev, steps=4):
    """prefill of ``toks`` into a window-sized ring (the flash kernel),
    then ``steps`` greedy dense decode steps; every logit and the final
    layer states."""
    from repro_torch.models import model

    st = model.make_decode_state(cfg, ctx, toks.shape[0],
                                 cfg.sliding_window, dev)
    st, logits = model.prefill(params, toks, st, cfg, ctx,
                               backend="cuda")
    outs = [logits]
    for _ in range(steps):
        st, logits = model.decode_step(params,
                                       logits.argmax(-1).to(torch.int32),
                                       st, cfg, ctx)
        outs.append(logits)
    return outs, st


def test_hybrid_prefill_and_decode_are_bit_reproducible(dev):
    """hymba-1.5b at full width cut to 2 layers, bf16: a flash prefill of
    2 prompts of 2,048 tokens (window 1,024) and 4 decode steps, twice
    from the same inputs: every logit and every layer state equal bit for
    bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import local_context

    cfg = get_config("hymba-1.5b").replace(num_layers=2,
                                           use_pallas_flash=True)
    ctx = local_context()
    params = init_params(0, cfg, ctx, dev)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (2, 2048)).astype(np.int32)).to(dev)
    fa.reset_launches()
    first, st1 = _hybrid_prefill_and_decode(cfg, ctx, params, toks, dev)
    second, st2 = _hybrid_prefill_and_decode(cfg, ctx, params, toks, dev)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 2 * cfg.num_layers
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for k in st1.layers:
        assert torch.equal(st1.layers[k], st2.layers[k]), k


# ------------------------------- training -----------------------------------

def _grad_fns(y):
    """The names of ``y``'s autograd node and the nodes it feeds from."""
    fn = y.grad_fn
    return {type(fn).__name__} | {type(n).__name__
                                  for n, _ in fn.next_functions if n}


def _plain_grads(fn, x, w, g):
    """grad_x, grad_w of the plain upcast product ``fn(x.float(),
    w.float())`` under autograd, cotangent ``g``: the f32 grads cast to
    the operands' dtype by autograd's own cast."""
    xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = fn(xs.float(), ws.float())
    return torch.autograd.grad(y, (xs, ws), g)


@pytest.mark.parametrize("m,i,o", [(1, 64, 32), (300, 1024, 2816),
                                   (4096, 1024, 3072), (512, 1024, 151936)])
def test_matmul_f32_function_matches_the_plain_product(dev, m, i, o):
    """``layers.matmul`` on bf16 operands under autograd goes through
    ``MatmulF32``: its f32 output equals ``torch.mm(out_dtype=f32)``, and
    its grads the plain upcast product's within 1e-2 of their largest
    |value| (the cast to bf16 is the same; the f32 products may sum in
    another order)."""
    from repro_torch.models import layers

    gen = torch.Generator(device=dev).manual_seed(m + o)
    x = torch.randn((m, i), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((i, o), generator=gen, device=dev) / i ** 0.5).to(
        torch.bfloat16)
    g = torch.randn((m, o), generator=gen, device=dev)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = layers.matmul(xs, ws)
    assert "MatmulF32Backward" in _grad_fns(y)
    assert y.dtype == torch.float32
    assert torch.equal(y.detach(), torch.mm(x, w, out_dtype=torch.float32))
    gx, gw = torch.autograd.grad(y, (xs, ws), g)
    px, pw = _plain_grads(torch.mm, x, w, g)
    for got, want in ((gx, px), (gw, pw)):
        assert got.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs().max()
        assert err <= 1e-2 * want.float().abs().max()
    with torch.no_grad():
        assert layers.matmul(xs, ws).grad_fn is None


@pytest.mark.parametrize("e,c,i,o", [(4, 8, 64, 32), (128, 40, 2048, 768),
                                     (8, 512, 768, 2048)])
def test_bmm_f32_function_matches_the_plain_product(dev, e, c, i, o):
    """``moe._bmm`` on bf16 operands under autograd goes through
    ``BmmF32``, held to the plain upcast ``bmm`` as the matmul is."""
    from repro_torch.models import moe

    gen = torch.Generator(device=dev).manual_seed(e * c)
    a = torch.randn((e, c, i), generator=gen, device=dev).to(torch.bfloat16)
    b = (torch.randn((e, i, o), generator=gen, device=dev) / i ** 0.5).to(
        torch.bfloat16)
    g = torch.randn((e, c, o), generator=gen, device=dev)
    a_s, b_s = a.clone().requires_grad_(), b.clone().requires_grad_()
    y = moe._bmm(a_s, b_s)
    assert "BmmF32Backward" in _grad_fns(y)
    assert torch.equal(y.detach(), torch.bmm(a, b, out_dtype=torch.float32))
    ga, gb = torch.autograd.grad(y, (a_s, b_s), g)
    pa_, pb = _plain_grads(torch.bmm, a, b, g)
    for got, want in ((ga, pa_), (gb, pb)):
        assert got.dtype == torch.bfloat16
        err = (got.float() - want.float()).abs().max()
        assert err <= 1e-2 * want.float().abs().max()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-moe-30b-a3b",
                                  "hymba-1.5b"])
def test_train_step_on_the_card_matches_the_cpu(dev, arch, monkeypatch):
    """One ``build_train_step`` of a reduced f32 config (remat on), TF32
    off: loss and grad norm within 1e-5, params within 2 lr + 1e-5 of
    their scale, the card against the CPU."""
    from repro_torch import configs, optim, tree
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.launch import train
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import local_context

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = configs.reduced(configs.get_config(arch)).replace(
        dtype="float32", remat=True)
    ctx = local_context()
    shape = configs.ShapeConfig("t", 32, 4, "train")
    batch = batch_for_step(cfg, shape, DataConfig(seed=2), 0)
    params = init_params(0, cfg, ctx, "cpu")
    opt = optim.init(params, optim.AdamWConfig())._replace(
        step=torch.tensor(1, dtype=torch.int32))
    step = train.build_train_step(cfg, ctx, optim.AdamWConfig(), chunk=8)
    outs = {}
    for d in ("cpu", dev):
        o = optim.OptState(_to(opt.m, d), _to(opt.v, d), opt.step.to(d))
        outs[str(d)] = step(_to(params, d), o, None,
                            {k: torch.from_numpy(v).to(d)
                             for k, v in batch.items()})
    (p_c, _, _, m_c), (p_g, _, _, m_g) = outs["cpu"], outs[str(dev)]
    lr = float(m_c["lr"])
    for k in ("loss", "grad_norm"):
        assert abs(float(m_g[k]) - float(m_c[k])) <= 1e-5 * abs(float(m_c[k]))
    for a, b in zip(tree.leaves(p_c), tree.leaves(p_g)):
        assert (b.cpu() - a).abs().max() <= 2 * lr + 1e-5 * a.abs().max()


def test_bf16_train_steps_on_the_card_go_through_the_functions(dev):
    """Two bf16 steps of a reduced qwen3-moe-30b-a3b with remat: both
    Functions run in the backward, losses and grad norms finite, the
    params keep bf16 and move."""
    from repro_torch import configs, optim, tree
    from repro_torch.data import DataConfig, batch_for_step
    from repro_torch.launch import train
    from repro_torch.models import init_params, layers, moe
    from repro_torch.parallel.sharding import local_context

    cfg = configs.reduced(configs.get_config("qwen3-moe-30b-a3b")).replace(
        remat=True)
    ctx = local_context()
    shape = configs.ShapeConfig("t", 64, 4, "train")
    params = init_params(1, cfg, ctx, dev)
    opt = optim.init(params, optim.AdamWConfig())._replace(
        step=torch.tensor(1, dtype=torch.int32, device=dev))
    step = train.build_train_step(cfg, ctx, optim.AdamWConfig(), chunk=8)
    calls = {"mm": 0, "bmm": 0}
    mm_bwd, bmm_bwd = (vars(layers.MatmulF32)["backward"],
                       vars(moe.BmmF32)["backward"])

    def count(name, fn):
        def wrapped(ctx_, g):
            calls[name] += 1
            return fn.__func__(ctx_, g)
        return staticmethod(wrapped)

    layers.MatmulF32.backward = count("mm", mm_bwd)
    moe.BmmF32.backward = count("bmm", bmm_bwd)
    try:
        p = params
        for s in range(2):
            batch = batch_for_step(cfg, shape, DataConfig(), s)
            p, opt, _, m = step(p, opt, None, {
                k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
            assert torch.isfinite(m["loss"]) and torch.isfinite(
                m["grad_norm"])
    finally:
        layers.MatmulF32.backward = mm_bwd
        moe.BmmF32.backward = bmm_bwd
    assert calls["mm"] > 0 and calls["bmm"] == 2 * 3 * cfg.num_layers
    for a, b in zip(tree.leaves(params), tree.leaves(p)):
        assert b.dtype == a.dtype
    assert not torch.equal(params["embed"]["tok"], p["embed"]["tok"])


# ------------- placement, single-slot pool forms, recurrent durability ------

def test_device_put_tier_host_pins_a_cuda_tensor(dev):
    from repro_torch.core import placement

    x = torch.arange(4096, dtype=torch.float32, device=dev).reshape(64, 64)
    y = placement.device_put_tier(x, placement.Tier.HOST)
    assert y.device.type == "cpu" and y.is_pinned()
    assert torch.equal(y, x.cpu())
    for tier in (placement.Tier.L2, placement.Tier.HBM):
        assert placement.device_put_tier(x, tier) is x


def test_single_slot_pool_forms_on_the_card_equal_the_cpu(dev):
    """ensure_capacity, append_token and release on CUDA tensors give the
    CPU's states bit for bit, ok flags and byte counts included."""
    from repro_torch.serving import kv_cache as pk
    from torch_port_helpers import assert_same

    cfg = pk.PagedKVConfig(num_pages=6, page_size=2, max_pages_per_seq=3,
                           kv_heads=2, head_dim=8, layers=2)
    rng = np.random.default_rng(9)
    states = {d: pk.make(cfg, batch=3, dtype=torch.bfloat16, device=d)
              for d in ("cpu", dev)}
    for _ in range(40):
        op, seq = int(rng.integers(0, 3)), int(rng.integers(0, 3))
        kv = torch.from_numpy(rng.normal(size=(2, cfg.layers, cfg.kv_heads,
                                               cfg.head_dim))).float()
        oks = {}
        for d, st in states.items():
            if op < 2:
                st, ok = pk.ensure_capacity(st, cfg, seq)
                oks[d] = bool(ok)
                if bool(ok):
                    k, v = kv.to(d, torch.bfloat16)
                    st = pk.append_token(st, cfg, seq, k, v)
            else:
                st = pk.release(st, cfg, seq)
            states[d] = st
        assert len(set(oks.values())) <= 1
        assert_same(states["cpu"], states[dev])
        assert int(pk.kv_bytes_in_use(states[dev], cfg)) == \
            int(pk.kv_bytes_in_use(states["cpu"], cfg))


@pytest.mark.parametrize("arch,prompt_len", [("hymba-1.5b", 2048),
                                             ("rwkv6-1.6b", 256)])
def test_recurrent_crash_cycle_on_the_card_equals_its_twin(dev, tmp_path,
                                                          arch, prompt_len):
    """A recurrent family at full width cut to 2 layers, bf16, on the dense
    kernel engine (hymba: prompts past its 1,024-token window, the flash
    prefill): flushed every 8 steps, killed after step 20, recovered into
    a fresh state equal to the one flushed at step 16, run on: the final
    state and every response equal the never-crashed twin's bit for
    bit."""
    from repro_torch.configs import get_config
    from repro_torch.fault import recovery as frec
    from repro_torch.launch import serve
    from repro_torch.models import init_params
    from repro_torch.parallel.sharding import local_context
    from torch_port_helpers import assert_same

    cfg = get_config(arch).replace(num_layers=2, use_pallas_flash=True)
    ctx = local_context()
    params = init_params(0, cfg, ctx, dev)
    ecfg = eng.LMEngineConfig(num_queues=2, capacity=8,
                              prompt_len=prompt_len, gen_len=24, slots=4,
                              admit_per_step=2, cache_len=1024)
    rng = np.random.default_rng(4)
    prompts = rng.integers(1, cfg.vocab_size, (6, prompt_len)).astype(
        np.int32)
    caps = rng.integers(12, 25, 6).astype(np.int32)

    def fresh():
        step, state = serve.build_engine(cfg, ctx, ecfg, params, dev)
        for lo in range(0, 6, 2):
            state = eng.lm_inject(state, torch.arange(2),
                                  prompts[lo:lo + 2], gen_caps=caps[lo:lo + 2])
        return step, state

    step, twin = fresh()
    fa.reset_launches()
    for _ in range(200):
        twin = step(twin)
        if int(twin.completed) == 6:
            break
    flash = fa.launches["flash_attention"]
    assert (flash > 0) == (arch == "hymba-1.5b")
    step, state = fresh()
    mgr = frec.DurabilityManager(frec.DurabilityConfig(
        str(tmp_path), every=8, mode="adaptive"))
    for t in range(1, 21):
        state = step(state)
        if t % 8 == 0:
            mgr.flush(state)
            flushed = interop.to_numpy(state)
    mgr.wait()
    assert int(state.completed) < 6
    assert [r.kind for r in mgr.records] == ["full", "full"]
    del state  # the kill
    recovered, covered = frec.recover(str(tmp_path), fresh()[1])
    assert covered == 16
    assert_same(flushed, recovered)
    for _ in range(200):
        if int(recovered.completed) == 6:
            break
        recovered = step(recovered)
    assert int(recovered.steps) == int(twin.steps)
    assert_same(twin, recovered)


# ---------------------------------------------------------------------------
# Ranks that share the card: gloo, CUDA tensors staged through host memory
# ---------------------------------------------------------------------------

def _chain_batches(n=4, b=6, seed=0):
    """Seeded transaction batches at the small SPMD shape (offsets in
    [0, 12) so transactions conflict) and their masks."""
    rng = np.random.default_rng(seed)
    cfg = tx.TxConfig(num_keys=256, val_words=4, max_ops=3, chain_len=3,
                      log_capacity=64)
    batches, masks = [], []
    for _ in range(n):
        batch = np.zeros((b, tx.tx_words(cfg)), np.int32)
        for i in range(b):
            k = int(rng.integers(1, 4))
            batch[i, 0] = k
            for j in range(k):
                base = 1 + j * (1 + cfg.val_words)
                batch[i, base] = int(rng.integers(0, 12))
                batch[i, base + 1:base + 1 + cfg.val_words] = rng.integers(
                    -9, 9, cfg.val_words)
        batches.append(batch)
        masks.append(rng.random(b) > 0.1)
    return batches, masks


def test_chain_commit_spmd_launches_commit_on_every_rank(dev):
    """3 ranks on the card, one replica each: every rank launches commit
    once a batch, and its replica and decisions equal chain_commit_local's
    (the commit_chain kernel) bit for bit."""
    import torch_multirank_ranks as ranks
    from repro_torch.parallel import collectives as coll

    batches, masks = _chain_batches()
    out = coll.launch(ranks.cuda_chain_rank, 3, backend="gloo",
                      args=(batches, masks), timeout=300)
    for r, (same, launches, committed) in enumerate(out):
        assert same, r
        assert launches == {"commit": len(batches),
                            "commit_chain": len(batches)}, launches
        assert committed == out[0][2] > 0


def test_host_staged_collectives_match_cpu(dev):
    """Every collective on CUDA tensors (staged through page-locked host
    buffers on gloo) returns what it returns on CPU tensors."""
    import torch_multirank_ranks as ranks
    from repro_torch.parallel import collectives as coll

    cpu = coll.launch(ranks.collectives_rank, 4, backend="gloo",
                      args=("cpu",), timeout=300)
    card = coll.launch(ranks.collectives_rank, 4, backend="gloo",
                       args=("cuda",), timeout=300)
    for a, b in zip(cpu, card):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


def test_tensor_parallel_form_backwards_on_the_card(dev):
    """Each model-axis form's backward (``model_psum``, ``model_copy``,
    ``model_reduce``, ``model_gather``, ``model_block``, ``all_to_all``)
    on CUDA tensors, over 2 ranks sharing the card (gloo, host-staged),
    against the one-process gradient of the same function on the card
    within 1e-6 of its scale; a tensor both ranks hold whole gets the
    same gradient bits on both."""
    import torch_tp_train_ranks as ttr
    from repro_torch.parallel import collectives as coll

    out = coll.launch(ttr.forms_rank, 2, backend="gloo", args=("cuda",),
                      timeout=300)
    for r, res in enumerate(out):
        assert set(res) == set(ttr.FORMS)
        for form, (got, want) in res.items():
            for a, b in zip(got, want):
                assert a.shape == b.shape, (r, form)
                scale = max(float(np.abs(b).max()), 1e-30)
                assert float(np.abs(a - b).max()) <= 1e-6 * scale, (r, form)
    for form in ("model_copy", "model_block"):
        np.testing.assert_array_equal(out[0][form][0][0], out[1][form][0][0])


def test_elastic_resume_defaults_to_the_card(dev, tmp_path):
    """``elastic.resume`` and ``restore`` from meta templates with no
    ``device`` put every leaf on the card, as JAX's resume places its
    arrays on the accelerator."""
    from repro_torch.checkpoint import checkpointer, elastic
    from repro_torch.launch import mesh as lmesh
    from repro_torch.parallel.sharding import P

    tree = {"w": torch.arange(32, dtype=torch.float32).reshape(8, 4),
            "b": torch.arange(4, dtype=torch.int32)}
    checkpointer.save(str(tmp_path), 2, tree)
    like = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}
    ctx = lmesh.make_context(lmesh.make_test_mesh((1,), ("data",)), None)
    got, step = elastic.resume(str(tmp_path), like, ctx,
                               specs={"w": P(), "b": P()})
    got2, _ = checkpointer.restore(str(tmp_path), 2, like)
    assert step == 2
    for out in (got, got2):
        for k, v in tree.items():
            assert out[k].device.type == "cuda", k
            assert torch.equal(out[k].cpu(), v), k
