"""The port's MoE block (``repro_torch/models/moe.py``) and the MoE family
of the stack and the paged entry points against the JAX package's, on the
reduced f32 configs of qwen3-moe-30b-a3b and grok-1-314b at capacity
factors 1.25 and 0.5 (``reduced``'s 16.0 never drops, so the drop path
would go untested there). Capacity, dispatch positions and the routed ids
(away from near ties) are equal bit for bit; outputs, aux losses and
logits hold to 1e-5. Every drop case asserts that an assignment really
was dropped. Inputs are made with numpy from a seed; parameters cross
from JAX through ``interop.lm_params_from_numpy``."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.parallel import sharding as jsharding
from repro.serving import kv_cache as jpk
from repro_torch import configs, interop
from repro_torch.models import model, moe
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding
from repro_torch.serving import kv_cache as pk

TOL = 1e-5
CPU = torch.device("cpu")
ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]
FACTORS = [1.25, 0.5]


def _t(x):
    return interop._tensor(np.asarray(x), CPU)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(interop.to_numpy(got), np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol)


def _cfgs(arch, cf, dtype="float32", **kw):
    j = jconfigs.reduced(jconfigs.get_config(arch)).replace(
        dtype=dtype, capacity_factor=cf, **kw)
    t = configs.reduced(configs.get_config(arch)).replace(
        dtype=dtype, capacity_factor=cf, **kw)
    return j, t


def _moe_params(jcfg, seed=0):
    jp = jmoe.moe_init(jax.random.key(seed), jcfg)
    return jp, interop.lm_params_from_numpy(interop.to_numpy(jp), CPU)


def _lm_params(jcfg):
    jp = jmodel.init_params(jax.random.key(1), jcfg,
                            jsharding.local_context())
    return jp, interop.lm_params_from_numpy(interop.to_numpy(jp), CPU)


def _skewed(rng, shape, router, lean=1.5):
    """Normal tokens leaning toward expert 0's router column, so experts
    overflow at capacity factor 1.25 too (real routers are skewed)."""
    col = np.asarray(router)[:, 0]
    return (rng.normal(size=shape)
            + lean * col / np.linalg.norm(col)).astype(np.float32)


@pytest.fixture
def drops(monkeypatch):
    """Counts the assignments every ``moe_apply`` call of the port drops:
    each call sizes its capacity (unless ``no_drop``), then dispatches."""
    seen = {"caps": [], "dropped": 0}
    cap_fn, pos_fn = moe._capacity, moe._dispatch_positions

    def capacity(tokens, cfg, experts):
        seen["caps"].append(cap_fn(tokens, cfg, experts))
        return seen["caps"][-1]

    def positions(flat_e, num_experts):
        pos = pos_fn(flat_e, num_experts)
        if seen["caps"]:
            seen["dropped"] += int((pos >= seen["caps"].pop()).sum())
        return pos

    monkeypatch.setattr(moe, "_capacity", capacity)
    monkeypatch.setattr(moe, "_dispatch_positions", positions)
    return seen


# ------------------------- routing and dispatch ----------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", FACTORS + [16.0])
def test_capacity_matches_jax(arch, cf):
    jcfg, tcfg = _cfgs(arch, cf)
    full_j, full_t = jconfigs.get_config(arch), configs.get_config(arch)
    for tokens in (1, 7, 8, 16, 33, 64, 100, 4096, 8 * 512, 32):
        for experts in (jcfg.num_experts, 1, 3, 16):
            assert moe._capacity(tokens, tcfg, experts) == \
                jmoe._capacity(tokens, jcfg, experts)
        assert moe._capacity(tokens, full_t, full_t.num_experts) == \
            jmoe._capacity(tokens, full_j, full_j.num_experts)


@pytest.mark.parametrize("n,experts", [(1, 4), (64, 4), (300, 8),
                                       (4096, 128), (257, 128)])
def test_dispatch_positions_match_jax(n, experts):
    """Keep and dest from the same expert ids, bit for bit (skewed ids, so
    some experts overflow and others stay empty)."""
    rng = np.random.default_rng(n + experts)
    ids = np.minimum(rng.zipf(1.3, n) - 1, experts - 1).astype(np.int32)
    jpos = np.asarray(jmoe._dispatch_positions(jnp.asarray(ids), experts))
    tpos = moe._dispatch_positions(torch.as_tensor(ids).long(), experts)
    assert tpos.dtype == torch.int32
    np.testing.assert_array_equal(tpos.numpy(), jpos)
    for cap in (1, 8, max(1, n // experts)):
        keep = tpos.numpy() < cap
        dest = np.where(keep, ids * cap + tpos.numpy(), experts * cap)
        np.testing.assert_array_equal(keep, jpos < cap)
        np.testing.assert_array_equal(
            dest, np.where(jpos < cap, ids * cap + jpos, experts * cap))


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_jax(arch):
    """The routed ids equal JAX's wherever the k-th and (k+1)-th gates
    differ by more than 1e-6; gates and aux within 1e-5."""
    jcfg, tcfg = _cfgs(arch, 1.25)
    jp, tp = _moe_params(jcfg)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(200, jcfg.d_model)).astype(np.float32)
    jg, ji, jaux = jmoe._route(jp, jnp.asarray(x), jcfg)
    tg, ti, taux = moe._route(tp, torch.as_tensor(x), tcfg)
    logits = x.astype(np.float64) @ np.asarray(jp["router"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    srt = -np.sort(-probs, axis=-1)
    k = jcfg.num_experts_per_tok
    clear = srt[:, k - 1] - srt[:, k] > 1e-6
    assert clear.sum() > 150
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])
    _close(tg, jg)
    _close(taux, jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_uniform_router_row_picks_the_lowest_experts(arch):
    """An all-zero token gives a uniform softmax: both packages pick
    experts 0..k-1 with equal gates, and the block agrees on it."""
    jcfg, tcfg = _cfgs(arch, 1.25)
    jp, tp = _moe_params(jcfg)
    x = np.random.default_rng(12).normal(size=(6, jcfg.d_model)).astype(
        np.float32)
    x[[0, 3]] = 0.0
    k = jcfg.num_experts_per_tok
    _, ji, _ = jmoe._route(jp, jnp.asarray(x), jcfg)
    tg, ti, _ = moe._route(tp, torch.as_tensor(x), tcfg)
    for row in (0, 3):
        assert np.asarray(ji)[row].tolist() == list(range(k))
        assert ti[row].tolist() == list(range(k))
        assert torch.equal(tg[row], torch.full((k,), 1.0 / k))
    jy, _ = jmoe.moe_apply(jp, jnp.asarray(x), jcfg,
                           jsharding.local_context())
    ty, _ = moe.moe_apply(tp, torch.as_tensor(x), tcfg)
    _close(ty, jy)


# ------------------------------ moe_apply ----------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("no_drop", [False, True])
def test_moe_apply_matches_jax(drops, arch, cf, no_drop):
    """Output and aux within 1e-5, with and without ``no_drop``; the drop
    cases drop assignments, the no_drop cases none."""
    jcfg, tcfg = _cfgs(arch, cf)
    jp, tp = _moe_params(jcfg, seed=3)
    x = _skewed(np.random.default_rng(13), (2, 24, jcfg.d_model),
                jp["router"])
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg,
                              jsharding.local_context(), no_drop=no_drop)
    ty, taux = moe.moe_apply(tp, torch.as_tensor(x), tcfg, no_drop=no_drop)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    _close(ty, jy)
    _close(taux, jaux)
    if no_drop:
        assert drops["dropped"] == 0
    else:
        assert drops["dropped"] > 0, "the drop case dropped nothing"


def test_moe_apply_bf16_matches_jax():
    """bf16 activations and experts, the f32 router inside them: the
    products return f32 before the one rounding to bf16."""
    jcfg, tcfg = _cfgs(ARCHS[0], 1.25, dtype="bfloat16")
    jp, tp = _moe_params(jcfg, seed=4)
    assert tp["router"].dtype == torch.float32
    assert tp["w_in"].dtype == torch.bfloat16
    x = jnp.asarray(np.random.default_rng(14).normal(
        size=(3, 10, jcfg.d_model)), jnp.bfloat16)
    jy, _ = jmoe.moe_apply(jp, x, jcfg, jsharding.local_context())
    ty, _ = moe.moe_apply(tp, _t(x), tcfg)
    assert ty.dtype == torch.bfloat16
    _close(ty, jy, 3e-2)


def test_capacity_tokens_keep_the_padded_batch_slots(drops):
    """A prefix of a batch, with its capacity sized from the whole
    batch's count, gives the prefix rows of the whole batch's output, and
    sized from its own count it drops more: the paged engine's repair."""
    jcfg, tcfg = _cfgs(ARCHS[0], 0.5)
    _, tp = _moe_params(jcfg, seed=5)
    x = torch.as_tensor(_skewed(np.random.default_rng(15),
                                (4, 16, jcfg.d_model),
                                np.asarray(tp["router"])))
    whole, _ = moe.moe_apply(tp, x, tcfg)
    dropped_whole = drops["dropped"]
    drops["dropped"] = 0
    prefix, _ = moe.moe_apply(tp, x[:1], tcfg, capacity_tokens=x.shape[0]
                              * x.shape[1])
    assert torch.equal(prefix, whole[:1])
    own, _ = moe.moe_apply(tp, x[:1], tcfg)
    assert dropped_whole > 0 and drops["dropped"] > 0
    assert not torch.equal(own, whole[:1])


# ------------------------- the stack and the model -------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", FACTORS)
def test_block_apply_matches_jax(drops, arch, cf):
    """One MoE block, stateless forward: JAX's output within 1e-5, with
    drops."""
    jcfg, tcfg = _cfgs(arch, cf)
    jp, tp = _lm_params(jcfg)
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    tlayer = tf.layer(tp["layers"], 0)
    assert set(tlayer) == {"ln1", "attn", "ln2", "moe"}
    jctx, tctx = jsharding.local_context(), sharding.local_context()
    x = _skewed(np.random.default_rng(16), (2, 16, jcfg.d_model),
                jlayer["moe"]["router"], lean=3.0)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    jy, _, _ = jtf.block_apply(jlayer, jnp.asarray(x), jcfg,
                               jtf.plan_for(jcfg, jctx), jctx,
                               jnp.asarray(pos))
    ty, _ = tf.block_apply(tlayer, torch.as_tensor(x), tcfg,
                           tf.plan_for(tcfg, tctx), tctx,
                           torch.as_tensor(pos.copy()))
    _close(ty, jy)
    assert drops["dropped"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("flash", [False, True])
def test_paged_prefill_and_decode_match_jax(drops, arch, cf, flash):
    """prefill_kv (chunked, or the flash kernel's plain version against
    JAX's interpret-mode kernel) with drops, then paged decode steps
    (no_drop): JAX's kv, logits, greedy tokens and pool."""
    jcfg, tcfg = _cfgs(arch, cf, use_pallas_flash=flash, flash_block=8)
    jp, tp = _lm_params(jcfg)
    jctx, tctx = jsharding.local_context(), sharding.local_context()
    rng = np.random.default_rng(17)
    toks = rng.integers(1, jcfg.vocab_size, (2, 32)).astype(np.int32)
    jk, jv, jl = jmodel.prefill_kv(jp, jnp.asarray(toks), jcfg, jctx)
    tk, tv, tl = model.prefill_kv(tp, torch.as_tensor(toks), tcfg, tctx)
    for a, b in ((tk, jk), (tv, jv), (tl, jl)):
        _close(a, b)
    assert drops["dropped"] > 0, "the prefill dropped nothing"
    jpc = jmodel.make_paged_kv_config(jcfg, jctx, num_pages=24, page_size=4,
                                      max_pages_per_seq=10)
    tpc = model.make_paged_kv_config(tcfg, tctx, num_pages=24, page_size=4,
                                     max_pages_per_seq=10)
    jkv = jpk.make(jpc, 3, jnp.float32)
    tkv = pk.make(tpc, 3, torch.float32, CPU)
    slots = np.asarray([2, 0], np.int32)
    mask = np.asarray([True, True])
    jkv, _ = jpk.prefill_into_pages(jkv, jpc, jnp.asarray(slots), jk, jv,
                                    jnp.asarray(mask))
    tkv, _ = pk.prefill_into_pages(tkv, tpc, _t(slots), _t(jk), _t(jv),
                                   _t(mask))
    nxt = np.zeros((3,), np.int32)
    nxt[slots] = np.asarray(jnp.argmax(jl, -1))
    active = np.asarray([True, False, True])
    drops["dropped"] = 0
    for _ in range(5):
        jkv, jlog, jok = jmodel.paged_decode_step(
            jp, jnp.asarray(nxt), jkv, jpc, jcfg, jctx,
            active=jnp.asarray(active), kernel_backend="ref")
        tkv, tlog, tok = model.paged_decode_step(
            tp, _t(nxt), tkv, tpc, tcfg, tctx, active=_t(active))
        assert np.array_equal(tok.numpy(), np.asarray(jok))
        _close(tlog[active], np.asarray(jlog)[active])
        nxt = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        assert np.array_equal(tlog[active].argmax(-1).numpy(), nxt[active])
    assert drops["dropped"] == 0 and not drops["caps"], "decode is no_drop"
    _close(tkv.k_pages, jkv.k_pages)
    _close(tkv.v_pages, jkv.v_pages)
    for f in ("page_table", "lengths", "free_stack", "free_top", "residency"):
        assert np.array_equal(getattr(tkv, f).numpy(),
                              np.asarray(getattr(jkv, f))), f


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_prefill_and_decode_match_jax(arch):
    """The ring-cache entry points (prefill of the padded batch, decode
    with no_drop) give JAX's logits and caches."""
    jcfg, tcfg = _cfgs(arch, 0.5)
    jp, tp = _lm_params(jcfg)
    jctx, tctx = jsharding.local_context(), sharding.local_context()
    toks = np.random.default_rng(18).integers(
        1, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jst = jmodel.make_decode_state(jcfg, jctx, 2, 24)
    tst = model.make_decode_state(tcfg, tctx, 2, 24, CPU)
    jst, jl = jmodel.prefill(jp, jnp.asarray(toks), jst, jcfg, jctx, chunk=8)
    tst, tl = model.prefill(tp, torch.as_tensor(toks), tst, tcfg, tctx,
                            chunk=8)
    _close(tl, jl)
    for _ in range(4):
        nxt = jnp.argmax(jl, -1).astype(jnp.int32)
        assert np.array_equal(np.asarray(nxt), tl.argmax(-1).numpy())
        jst, jl = jmodel.decode_step(jp, nxt, jst, jcfg, jctx)
        tst, tl = model.decode_step(tp, _t(nxt), tst, tcfg, tctx)
        _close(tl, jl)
    _close(tst.layers["k"], jst.layers["k"])
