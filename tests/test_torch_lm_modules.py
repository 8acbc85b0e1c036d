"""The port's LM modules against the JAX package's, module by module: the
configs and head plan, ``layers`` and ``attention`` (merge_fresh_token and
the read-only paged decode included); the stack, the model and the pool
are in test_torch_lm_stack.py.
Inputs are made with numpy from a seed; parameters cross from JAX through
``interop.lm_params_from_numpy``. f32 comparisons hold to 1e-5 (the
summation order differs between the frameworks); integer state is equal
bit for bit."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import transformer as jtf
from repro.parallel import sharding as jsharding
from repro_torch import configs, interop
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import model
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding

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


# ------------------------------ configs ------------------------------------

@pytest.mark.parametrize("arch", jconfigs.all_arch_ids())
def test_configs_match_jax(arch):
    j, t = jconfigs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(jconfigs.reduced(j)) == dataclasses.asdict(
        configs.reduced(t))
    assert jconfigs.param_count(j) == configs.param_count(t)
    assert (j.padded_vocab, j.resolved_head_dim) == (t.padded_vocab,
                                                     t.resolved_head_dim)


@pytest.mark.parametrize("h,kv,tp", [(40, 8, 1), (16, 16, 1), (40, 8, 16),
                                     (28, 4, 16), (25, 5, 4), (4, 1, 1)])
def test_head_plan_matches_jax(h, kv, tp):
    j, t = jsharding.head_plan(h, kv, tp), sharding.head_plan(h, kv, tp)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.kv_phys, j.group) == (t.kv_phys, t.group)


def test_non_dense_families_raise():
    """A family the port does not know raises NotImplementedError, and the
    paged path refuses the recurrent families, as JAX's does."""
    cfg = configs.reduced(configs.get_config("qwen2.5-14b")).replace(
        dtype="float32", family="retnet")
    with pytest.raises(NotImplementedError):
        model.init_params(0, cfg, sharding.local_context(), CPU)
    for arch in ("rwkv6-1.6b", "hymba-1.5b"):
        jcfg, tcfg = _cfgs(arch)
        with pytest.raises(NotImplementedError):
            jmodel.check_paged_support(jcfg)
        with pytest.raises(NotImplementedError):
            model.check_paged_support(tcfg)


FAMILY_ARCHS = ["qwen2.5-14b", "qwen3-moe-30b-a3b", "qwen2-vl-7b",
                "musicgen-large", "rwkv6-1.6b", "hymba-1.5b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_init_params_shapes_and_scale_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, _ = _params(jcfg)
    tp = model.init_params(0, tcfg, sharding.local_context(), CPU)
    a, b = interop.to_numpy(jp), interop.to_numpy(tp)

    def walk(x, y, path):
        if isinstance(x, dict):
            assert x.keys() == y.keys(), path
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
            return
        assert (x.shape, x.dtype) == (y.shape, y.dtype), path
        # same distribution: equal zero pattern, comparable spread
        np.testing.assert_array_equal(x == 0, y == 0, err_msg=path)
        if x.std() > 0:
            assert 0.5 < y.std() / x.std() < 2.0, path

    walk(a, b, "params")


# ------------------------------ layers -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_jax(dtype):
    """matmul returns f32 from bf16 operands; rmsnorm, rope (split halves),
    swiglu MLP, embedding and the masked LM head agree."""
    jcfg, tcfg = _cfgs("qwen2.5-14b", dtype)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(0)
    jd = jnp.dtype(dtype)
    x = jnp.asarray(rng.normal(size=(2, 5, jcfg.d_model)), jd)
    tx = _t(x)
    tol = TOL if dtype == "float32" else 2e-2
    w = jp["layers"]["mlp"]["w_in"][0]
    got = layers.matmul(tx, _t(w))
    assert got.dtype == torch.float32
    _close(got, jlayers.matmul(x, w), tol)
    ln = {"scale": jp["layers"]["ln1"]["scale"][0]}
    _close(layers.rmsnorm({"scale": _t(ln["scale"])}, tx),
           jlayers.rmsnorm(ln, x), tol)
    mlp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["mlp"])
    _close(layers.mlp_apply(interop.lm_params_from_numpy(
        interop.to_numpy(mlp), CPU), tx), jlayers.mlp_apply(mlp, x), tol)
    pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    xr = jnp.asarray(rng.normal(size=(2, 5, 3, 8)), jd)
    _close(layers.apply_rope(_t(xr), torch.as_tensor(pos), 1e6),
           jlayers.apply_rope(xr, jnp.asarray(pos), 1e6), tol)
    toks = rng.integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
    _close(layers.embed_apply(tp["embed"], torch.as_tensor(toks), tcfg),
           jlayers.embed_apply(jp["embed"], jnp.asarray(toks), jcfg), tol)
    got = layers.lm_head_apply(tp["lm_head"], tx, tcfg, tp["embed"])
    assert got.dtype == torch.float32
    _close(got, jlayers.lm_head_apply(jp["lm_head"], x, jcfg, jp["embed"]),
           tol)


def test_tied_lm_head_and_padded_vocab_match_jax():
    jcfg, tcfg = _cfgs("qwen1.5-0.5b", vocab_size=100)  # pads to 128
    jp, tp = _params(jcfg)
    x = jnp.asarray(np.random.default_rng(1).normal(
        size=(2, 3, jcfg.d_model)), jnp.float32)
    got = layers.lm_head_apply(None, _t(x), tcfg, tp["embed"])
    _close(got, jlayers.lm_head_apply(None, x, jcfg, jp["embed"]))
    assert bool((got[..., 100:] == -1e30).all())


def test_mrope_matches_jax():
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(2, 5, 3, 16)), jnp.float32)
    pos = rng.integers(0, 50, (3, 2, 5)).astype(np.int32)
    _close(layers.apply_mrope(_t(x), torch.as_tensor(pos), 1e4),
           jlayers.apply_mrope(x, jnp.asarray(pos), 1e4))


# ------------------------------ attention ----------------------------------

def _attn_params(jp):
    a = jax.tree_util.tree_map(lambda t: t[0], jp["layers"]["attn"])
    return a, interop.lm_params_from_numpy(interop.to_numpy(a), CPU)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "qwen1.5-0.5b"])
def test_qkv_out_proj_and_prefill_attention_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, _ = _params(jcfg)
    ja, ta = _attn_params(jp)
    plan_j = jtf.plan_for(jcfg, jsharding.local_context())
    plan_t = tf.plan_for(tcfg, sharding.local_context())
    rng = np.random.default_rng(3)
    s = 24
    x = jnp.asarray(rng.normal(size=(2, s, jcfg.d_model)), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (2, s))
    jq, jk, jv = jattn.qkv(ja, x, jcfg, plan_j, pos)
    tq, tk, tv = attn.qkv(ta, _t(x), tcfg, plan_t, _t(pos))
    for a, b in ((tq, jq), (tk, jk), (tv, jv)):
        _close(a, b)
    tq, tk, tv = _t(jq), _t(jk), _t(jv)  # same inputs from here on
    _close(attn.full_attention(tq, tk, tv), jattn.full_attention(jq, jk, jv))
    for window, chunk in ((0, 8), (0, 7), (10, 8)):
        _close(attn.chunked_attention(tq, tk, tv, window=window, chunk=chunk),
               jattn.chunked_attention(jq, jk, jv, window=window,
                                       chunk=chunk))
    _close(attn.out_proj(ta, tq, plan_t), jattn.out_proj(ja, jq, plan_j))


def test_attention_block_matches_jax():
    """The module forward: stateless, prefill into a cache, then decode
    steps writing at ``lengths - 1``."""
    jcfg, tcfg = _cfgs("qwen2.5-14b")
    jp, _ = _params(jcfg)
    ja, ta = _attn_params(jp)
    plan_j = jtf.plan_for(jcfg, jsharding.local_context())
    plan_t = tf.plan_for(tcfg, sharding.local_context())
    rng = np.random.default_rng(9)
    b, s, smax = 2, 6, 10
    x = jnp.asarray(rng.normal(size=(b, s, jcfg.d_model)), jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    jy, _ = jattn.attention_block(ja, x, jcfg, plan_j, pos, chunk=4)
    ty, _ = attn.attention_block(ta, _t(x), tcfg, plan_t, _t(pos), chunk=4)
    _close(ty, jy)
    shape = (b, smax, plan_j.kv_phys, jcfg.resolved_head_dim)
    jc = jattn.KVCache(jnp.zeros(shape), jnp.zeros(shape))
    tc = attn.KVCache(torch.zeros(shape), torch.zeros(shape))
    jy, jc = jattn.attention_block(ja, x, jcfg, plan_j, pos, cache=jc,
                                   chunk=4)
    ty, tc = attn.attention_block(ta, _t(x), tcfg, plan_t, _t(pos),
                                  cache=tc, chunk=4)
    _close(ty, jy)
    for step in range(3):
        x1 = jnp.asarray(rng.normal(size=(b, 1, jcfg.d_model)), jnp.float32)
        p1 = jnp.full((b, 1), s + step, jnp.int32)
        ln = jnp.full((b,), s + step + 1, jnp.int32)
        jy, jc = jattn.attention_block(ja, x1, jcfg, plan_j, p1, cache=jc,
                                       lengths=ln)
        ty, tc = attn.attention_block(ta, _t(x1), tcfg, plan_t, _t(p1),
                                      cache=tc, lengths=_t(ln))
        _close(ty, jy)
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)


def test_decode_attention_and_merge_fresh_token_match_jax():
    rng = np.random.default_rng(4)
    b, kvh, g, hd, smax = 3, 2, 3, 8, 12
    q = jnp.asarray(rng.normal(size=(b, 1, kvh * g, hd)), jnp.float32)
    kc = jnp.asarray(rng.normal(size=(b, smax, kvh, hd)), jnp.float32)
    vc = jnp.asarray(rng.normal(size=(b, smax, kvh, hd)), jnp.float32)
    ln = jnp.asarray([1, 7, smax], jnp.int32)
    for window in (0, 4):
        _close(attn.decode_attention(_t(q), _t(kc), _t(vc), _t(ln),
                                     window=window),
               jattn.decode_attention(q, kc, vc, ln, window=window))
    acc = jnp.asarray(rng.normal(size=(b, kvh, g, hd)), jnp.float32)
    m = jnp.asarray(rng.normal(size=(b, kvh, g)), jnp.float32).at[0].set(-1e30)
    l = jnp.asarray(rng.uniform(1, 3, (b, kvh, g)), jnp.float32).at[0].set(0)
    s_cur = jnp.asarray(rng.normal(size=(b, kvh, g)), jnp.float32)
    v_new = jnp.asarray(rng.normal(size=(b, kvh, hd)), jnp.float32)
    _close(attn.merge_fresh_token(_t(acc), _t(m), _t(l), _t(s_cur),
                                  _t(v_new)),
           jattn.merge_fresh_token(acc, m, l, s_cur, v_new))


def test_paged_decode_ro_matches_jax_and_write_then_attend():
    """The read-only identity: stats over the stale pool + the fresh
    token's merge == writing the token first and attending; and both
    equal JAX's."""
    rng = np.random.default_rng(8)
    b, kvh, g, hd, ps, maxp = 2, 2, 3, 16, 4, 3
    npages = b * maxp + 1
    lengths = np.asarray([5, ps * maxp - 1], np.int32)
    kp = np.zeros((npages, ps, kvh, hd), np.float32)
    vp = np.zeros_like(kp)
    pt = np.full((b, maxp), -1, np.int32)
    nxt = 0
    for i in range(b):
        for t in range(int(lengths[i]) + 1):
            if t % ps == 0:
                pt[i, t // ps] = nxt
                nxt += 1
            if t < lengths[i]:
                kp[pt[i, t // ps], t % ps] = rng.normal(size=(kvh, hd))
                vp[pt[i, t // ps], t % ps] = rng.normal(size=(kvh, hd))
    q = rng.normal(size=(b, 1, kvh * g, hd)).astype(np.float32)
    k_new = rng.normal(size=(b, kvh, hd)).astype(np.float32)
    v_new = rng.normal(size=(b, kvh, hd)).astype(np.float32)
    got = attn.paged_decode_attention_ro(
        _t(q), _t(kp), _t(vp), _t(pt), _t(lengths), _t(k_new), _t(v_new))
    want = jattn.paged_decode_attention_ro(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pt),
        jnp.asarray(lengths), jnp.asarray(k_new), jnp.asarray(v_new),
        use_ref=True)
    _close(got, want)
    kp2, vp2 = kp.copy(), vp.copy()
    for i in range(b):
        t = int(lengths[i])
        kp2[pt[i, t // ps], t % ps] = k_new[i]
        vp2[pt[i, t // ps], t % ps] = v_new[i]
    wrote = attn.paged_decode_attention(_t(q), _t(kp2), _t(vp2), _t(pt),
                                        _t(lengths + 1))
    torch.testing.assert_close(got, wrote, rtol=2e-5, atol=2e-5)
