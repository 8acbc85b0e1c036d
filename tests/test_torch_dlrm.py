"""The DLRM slice of the PyTorch port against the JAX package: the
embedding reduction's plain version against the Pallas kernel in
interpret mode and against ``ref.dlrm_embedding_reduce`` (bit for bit,
f32 and bf16 tables), ``core/dlrm.py`` with JAX's params carried across
(embedding sums bit for bit, logits within the JAX package's own
tolerance), the host-side MERCI rewrite and query generator (equal for
one seed), and DLRM inference through the engine.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dlrm as jdl
from repro.core import engine as jeng
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import interop
from repro_torch.core import dlrm as tdl
from repro_torch.core import engine as teng
from repro_torch.core import status as tst
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_port_helpers import assert_same, t

CFG_KW = dict(num_tables=3, rows=64, dim=16, lookups=8, dense_features=5,
              cluster=4, memo_ratio=0.25)
JCFG, TCFG = jdl.DLRMConfig(**CFG_KW), tdl.DLRMConfig(**CFG_KW)
# logits: the tolerance of the JAX package's own kernel-vs-forward check
# (tests/test_kernel_dispatch.py); the MLP matmuls sum in another order
# in XLA than in PyTorch, so logits are not bit-equal, the sums are
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def params():
    """JAX's params, and the same params carried across to the port."""
    jp = jdl.init_params(jax.random.key(0), JCFG)
    return jp, interop.dlrm_params_from_numpy(interop.to_numpy(jp), "cpu")


# --------------------------- embedding kernel -------------------------------

def _segments(rng, n, num_segments, empty):
    """(N,) non-decreasing segment ids over ``num_segments``, with the
    segments in ``empty`` left out."""
    keep = np.setdiff1d(np.arange(num_segments), empty)
    return np.sort(rng.choice(keep, n)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,num_segments,d", [(1, 1, 8), (24, 6, 16),
                                              (64, 11, 40)])
def test_embedding_reduce_plain_matches_pallas(dtype, n, num_segments, d):
    """ops.embedding_reduce (plain version) vs the Pallas kernel in
    interpret mode plus the JAX wrapper's zeroing: empty segments (first,
    middle and last) and duplicate rows, bit for bit. bf16 tables are
    exact in f32, and the adds are f32 in lookup order on both sides."""
    rng = np.random.default_rng(n + d)
    r = 32
    table = rng.normal(size=(r, d)).astype(np.float32)
    jtab = jnp.asarray(table, getattr(jnp, dtype))
    idx = rng.integers(0, r, n).astype(np.int32)
    idx[n // 2:] = idx[: n - n // 2]  # duplicate rows
    empty = [0, num_segments // 2, num_segments - 1] if num_segments > 2 else []
    seg = _segments(rng, n, num_segments, empty)
    want = jops.embedding_reduce(jtab, jnp.asarray(idx), jnp.asarray(seg),
                                 num_segments, interpret=True)
    ttab = interop.dlrm_params_from_numpy(
        {"tables": np.asarray(jtab), "bottom": [], "top": []}, "cpu")["tables"]
    assert ttab.dtype == getattr(torch, dtype)
    got = tops.embedding_reduce(ttab, t(idx), t(seg), num_segments)
    assert_same(want, got, "embedding_reduce")
    for s in empty:
        assert not got[s].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dlrm_embedding_reduce_matches_jax(dtype):
    """ref.dlrm_embedding_reduce vs JAX's, bit for bit; and the general
    plain version on the flattened layout gives the same sums."""
    rng = np.random.default_rng(1)
    tables = jnp.asarray(rng.normal(size=(3, 20, 8)).astype(np.float32),
                         getattr(jnp, dtype))
    idx = rng.integers(0, 20, (4, 3, 6)).astype(np.int32)
    idx[:, 0, 3:] = idx[:, 0, :3]
    ttab = interop.dlrm_params_from_numpy(
        {"tables": np.asarray(tables), "bottom": [], "top": []}, "cpu")["tables"]
    want = jref.dlrm_embedding_reduce(tables, jnp.asarray(idx))
    assert_same(want, tref.dlrm_embedding_reduce(ttab, t(idx)), "dlrm ref")
    assert_same(want, tdl.embedding_reduce(ttab, t(idx), backend="auto"),
                "flattened")


# ------------------------------ dlrm module ---------------------------------

def test_init_params_shapes_and_distributions():
    """The port draws its own params (it cannot replay jax.random): the
    same tree, shapes and dtypes as JAX's, N(0,1)·0.1 tables, N(0,1)/√d_in
    weights, zero biases."""
    cfg = tdl.DLRMConfig(num_tables=4, rows=512, dim=32, lookups=4)
    p = tdl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jdl.init_params(jax.random.key(0), jdl.DLRMConfig(*cfg))
    shapes = jax.tree_util.tree_map(lambda x: (x.shape, str(x.dtype)), jp)
    assert shapes == jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), str(x.dtype).split(".")[1]), p)
    assert abs(float(p["tables"].std()) - 0.1) < 0.005
    w = p["bottom"][1]["w"]
    assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1) < 0.05
    assert not any(layer["b"].any() for layer in p["bottom"] + p["top"])
    again = tdl.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    assert_same(p, again)
    bf = tdl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.bfloat16)
    assert bf["tables"].dtype == torch.bfloat16


@pytest.mark.parametrize("backend", ["ref", "auto"])
def test_forward_matches_jax(params, backend):
    """forward on JAX's params: embedding sums bit for bit (through
    embedding_reduce), logits within RTOL/ATOL; with and without MERCI
    tables."""
    jp, tp = params
    rng = np.random.default_rng(2)
    merci = jdl.MerciIndex(JCFG, seed=0)
    dense, idx = jdl.gen_queries(JCFG, 6, merci, 0.7, rng)
    new_idx, saved = merci.rewrite_query(idx)
    assert saved > 0
    jext = merci.build_tables(jp["tables"])
    text = tdl.MerciIndex(TCFG, seed=0).build_tables(tp["tables"])
    assert_same(jext, text, "build_tables")
    jbackend = "pallas" if backend == "auto" else backend
    for ext_j, ext_t, ix in ((None, None, idx), (jext, text, new_idx)):
        tabs_j = jp["tables"] if ext_j is None else ext_j
        tabs_t = tp["tables"] if ext_t is None else ext_t
        assert_same(jdl.embedding_reduce(tabs_j, jnp.asarray(ix),
                                         backend=jbackend),
                    tdl.embedding_reduce(tabs_t, t(ix), backend=backend),
                    "embedding sums")
        want = jdl.forward(jp, jnp.asarray(dense), jnp.asarray(ix), JCFG,
                           tables_ext=ext_j, backend=jbackend)
        got = tdl.forward(tp, t(dense), t(ix), TCFG, tables_ext=ext_t,
                          backend=backend)
        assert got.dtype == torch.float32 and got.shape == (6,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_app_step_matches_jax(params):
    """app_step with NOP, INFER, an unknown opcode, an out-of-range index
    and an invalid row: statuses bit for bit, logits within RTOL/ATOL."""
    jp, tp = params
    rng = np.random.default_rng(3)
    b = 7
    dense, idx = jdl.gen_queries(JCFG, b, None, 0.0, rng)
    w = jdl.request_words(JCFG) + 2  # wider ring entries than the payload
    assert tdl.request_words(TCFG) == jdl.request_words(JCFG)
    pl = np.zeros((b, w), np.int32)
    pl[:, 0] = jdl.OP_INFER
    pl[:, 1: 1 + JCFG.dense_features] = dense.view(np.int32)
    pl[:, 1 + JCFG.dense_features: w - 2] = idx.reshape(b, -1)
    pl[1, 0] = jdl.OP_NOP
    pl[2, 0] = 7  # unknown opcode
    pl[3, -3] = JCFG.rows  # index out of range
    pl[4, 1 + JCFG.dense_features] = -1  # negative index
    valid = np.ones(b, bool)
    valid[5] = False
    _, jr = jdl.app_step(jp, jnp.asarray(pl), jnp.asarray(valid), JCFG,
                         kernel_backend="pallas")
    tp_out, tr = tdl.app_step(tp, t(pl), t(valid), TCFG)
    assert tp_out is tp
    jr, tr = np.asarray(jr), tr.numpy()
    np.testing.assert_array_equal(jr[:, 0], tr[:, 0])
    np.testing.assert_array_equal(jr[:, 2:], tr[:, 2:])
    assert tr[:, 0].tolist() == [1, 0, tst.MALFORMED, tst.MALFORMED,
                                 tst.MALFORMED, 0, 1]
    np.testing.assert_allclose(tr[:, 1].view(np.float32),
                               jr[:, 1].view(np.float32), rtol=RTOL,
                               atol=ATOL)
    assert (tr[1:6, 1] == 0).all()


# ------------------------------ MERCI ---------------------------------------

def test_merci_and_queries_equal_jax_for_one_seed(params):
    jp, tp = params
    jm, tm = jdl.MerciIndex(JCFG, seed=4), tdl.MerciIndex(TCFG, seed=4)
    assert jm.n_memo == tm.n_memo
    np.testing.assert_array_equal(jm.pairs, tm.pairs)
    assert jm.lookup == tm.lookup
    for hit_rate, merci in ((0.0, None), (0.8, "merci")):
        jq = jdl.gen_queries(JCFG, 9, jm if merci else None, hit_rate,
                             np.random.default_rng(5))
        tq = tdl.gen_queries(TCFG, 9, tm if merci else None, hit_rate,
                             np.random.default_rng(5))
        assert_same(jq, tq, "gen_queries")
        jr, js = jm.rewrite_query(jq[1])
        tr, ts = tm.rewrite_query(tq[1])
        np.testing.assert_array_equal(jr, tr)
        assert js == ts
    bf = jp["tables"].astype(jnp.bfloat16)
    tbf = interop.dlrm_params_from_numpy(
        {"tables": np.asarray(bf), "bottom": [], "top": []}, "cpu")["tables"]
    assert_same(jm.build_tables(bf), tm.build_tables(tbf), "bf16 build")


# ------------------------------ engine --------------------------------------

def _serve(side, params_, rounds=3):
    """Seeded DLRM requests through one engine: INFER, NOP, an unknown
    opcode and out-of-range indices. Returns the final state and every
    drained response."""
    mod_e, mod_d, cfg = ((jeng, jdl, JCFG) if side == "jax"
                         else (teng, tdl, TCFG))
    w = mod_d.request_words(cfg)
    ecfg = mod_e.EngineConfig(num_queues=2, capacity=8, req_words=w,
                              resp_words=w, budget=4,
                              kernel_backend="pallas" if side == "jax"
                              else "auto")
    state = mod_e.make(ecfg, params_)
    app_fn = mod_e.bind_app(mod_d.app_step, cfg, ecfg)
    if side == "jax":
        step = jax.jit(lambda s: jeng.engine_step(s, app_fn, ecfg))
        arr = jnp.asarray
    else:
        step = lambda s: teng.engine_step(s, app_fn, ecfg)  # noqa: E731
        arr = t
    rng = np.random.default_rng(6)
    out = []
    for _ in range(rounds):
        dense, idx = jdl.gen_queries(JCFG, 2, None, 0.0, rng)
        pl = np.zeros((2, w), np.int32)
        pl[:, 0] = rng.choice([0, 1, 1, 1, 5], 2)
        pl[:, 1: 1 + cfg.dense_features] = dense.view(np.int32)
        pl[:, 1 + cfg.dense_features:] = idx.reshape(2, -1)
        if rng.random() < 0.4:
            pl[0, -1] = cfg.rows + 3
        state = mod_e.inject(state, arr(np.array([0, 1], np.int32)), arr(pl))
        state, stats = step(state)
        pay, counts, state = mod_e.drain_responses(state, 4)
        out.append((stats, pay, counts, pl))
    return state, out


def test_engine_dlrm_matches_jax_and_direct_forward(params):
    """The twin of the JAX package's DLRM-through-the-engine kernel test:
    response logits equal a direct forward() on the same queries, and the
    responses equal JAX's engine's (statuses bit for bit, logits within
    RTOL/ATOL)."""
    jp, tp = params
    js, jout = _serve("jax", jp)
    ts, tout = _serve("torch", tp)
    assert ts.req.entries.device.type == "cpu"
    f = TCFG.dense_features
    n_infer = 0
    for (jst, jpay, jcnt, pl), (tst_, tpay, tcnt, _) in zip(jout, tout):
        assert_same((jst, jcnt), (tst_, tcnt))
        jpay, tpay = np.asarray(jpay), tpay.numpy()
        np.testing.assert_array_equal(jpay[..., 0], tpay[..., 0])
        np.testing.assert_array_equal(jpay[..., 2:], tpay[..., 2:])
        np.testing.assert_allclose(tpay[..., 1].view(np.float32),
                                   jpay[..., 1].view(np.float32), rtol=RTOL,
                                   atol=ATOL)
        got = tpay[:, 0]  # one response per queue, queue q = request q
        dense = pl[:, 1: 1 + f].view(np.float32)
        idx = pl[:, 1 + f:].reshape(2, TCFG.num_tables, TCFG.lookups)
        ok = (pl[:, 0] == 1) & (idx < TCFG.rows).all(axis=(1, 2))
        expect = tdl.forward(tp, t(dense), t(np.clip(idx, 0, TCFG.rows - 1)),
                             TCFG, backend="auto").numpy()
        np.testing.assert_array_equal(got[:, 0], np.where(
            ok, 1, np.where(pl[:, 0] == 0, 0, tst.MALFORMED)))
        np.testing.assert_allclose(got[ok, 1].view(np.float32), expect[ok],
                                   rtol=RTOL, atol=ATOL)
        n_infer += int(ok.sum())
    assert n_infer > 0
    assert_same(js.steps, ts.steps)


def test_engine_make_puts_rings_on_the_params_device(params):
    """engine.make on CPU DLRM params (a dict of lists) builds the rings on
    the CPU: the device comes from the app state, however it nests."""
    _, tp = params
    ecfg = teng.EngineConfig(num_queues=2, capacity=4, req_words=4,
                             resp_words=4, budget=2)
    state = teng.make(ecfg, tp)
    for x in (state.req.entries, state.resp.entries, state.cpoll.ring_tracker,
              state.sched.rr_ptr, state.steps):
        assert x.device.type == "cpu"
    assert teng._device_of({"a": [{"b": tp["tables"]}]}).type == "cpu"
    assert teng._device_of({"a": []}) is None


def test_interop_carries_a_dlrm_engine_state_both_ways(params):
    """A DLRM EngineState (params dict as the app state, bf16 tables
    included) crosses JAX -> port -> numpy whole, every array copied."""
    jp, _ = params
    jp16 = {**jp, "tables": jp["tables"].astype(jnp.bfloat16)}
    ecfg = jeng.EngineConfig(num_queues=2, capacity=4, req_words=4,
                             resp_words=4, budget=2)
    js = jeng.make(ecfg, jp16)
    d = interop.to_numpy(js)
    ts = interop.engine_state_from_numpy(
        d, "cpu", app_from_numpy=interop.dlrm_params_from_numpy)
    assert ts.app["tables"].dtype == torch.bfloat16
    assert_same(js, ts)
    ts.app["top"][0]["w"].fill_(3.0)
    assert_same(jp16, interop.dlrm_params_from_numpy(d["app"], "cpu"))


def test_embedding_kernel_takes_cuda_tensors_only(params):
    from repro_torch.kernels import embedding_reduce as ter

    _, tp = params
    idx = torch.zeros((2, TCFG.num_tables, TCFG.lookups), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tdl.embedding_reduce(tp["tables"], idx, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ter.embedding_reduce(tp["tables"][0], idx[0, 0], idx[0, 0], 1)


def test_engine_carries_merci_tables_through_bind_app(params):
    """bind_app(dlrm.app_step, ..., tables_ext=ext) serves MERCI-rewritten
    index lists through the extended tables: each logit equals a direct
    forward on the rewritten queries, and the raw queries' logits within
    the JAX package's MERCI tolerance (tests/test_dlrm.py)."""
    _, tp = params
    merci = tdl.MerciIndex(TCFG, seed=1)
    ext = merci.build_tables(tp["tables"])
    rng = np.random.default_rng(8)
    dense, idx = tdl.gen_queries(TCFG, 2, merci, 0.9, rng)
    new_idx, saved = merci.rewrite_query(idx)
    assert saved > 0
    w = tdl.request_words(TCFG)
    ecfg = teng.EngineConfig(num_queues=2, capacity=4, req_words=w,
                             resp_words=w, budget=2)
    state = teng.make(ecfg, tp)
    app_fn = teng.bind_app(tdl.app_step, TCFG, ecfg, tables_ext=ext)
    pl = np.zeros((2, w), np.int32)
    pl[:, 0] = tdl.OP_INFER
    pl[:, 1: 1 + TCFG.dense_features] = dense.view(np.int32)
    pl[:, 1 + TCFG.dense_features:] = new_idx.reshape(2, -1)
    state = teng.inject(state, torch.tensor([0, 1], dtype=torch.int32), t(pl))
    state, _ = teng.engine_step(state, app_fn, ecfg)
    pay, counts, _ = teng.drain_responses(state, 2)
    got = pay[:, 0].numpy()
    assert (got[:, 0] == 1).all()
    logits = got[:, 1].view(np.float32)
    want = tdl.forward(tp, t(dense), t(new_idx), TCFG, tables_ext=ext,
                       backend="auto").numpy()
    np.testing.assert_allclose(logits, want, rtol=RTOL, atol=ATOL)
    raw = tdl.forward(tp, t(dense), t(idx), TCFG, backend="auto").numpy()
    np.testing.assert_allclose(logits, raw, rtol=1e-3, atol=1e-4)
