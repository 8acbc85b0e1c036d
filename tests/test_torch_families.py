"""The four families beyond dense and MoE against the JAX package, on
reduced f32 configs: qwen2-vl-7b (vlm: M-RoPE, media embeddings),
musicgen-large (audio: codebook frames), rwkv6-1.6b (ssm: attention-free)
and hymba-1.5b (hybrid: windowed attention + Mamba). One block, stateless
and prefilling a fresh state; the model's prefill (logits and every layer
state) and 8 greedy decode steps; the vlm media add; the codebook shapes;
the M-RoPE positions. Inputs are made with numpy from a seed, parameters
cross from JAX through ``interop``; held to 1e-5."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import transformer as jtf
from repro.parallel import sharding as jsharding
from repro_torch import configs, interop
from repro_torch.models import model
from repro_torch.models import transformer as tf
from repro_torch.parallel import sharding

TOL = 1e-5
CPU = torch.device("cpu")
ARCHS = ["qwen2-vl-7b", "musicgen-large", "rwkv6-1.6b", "hymba-1.5b"]
S = 12  # past hymba's reduced window of 8


def _close(got, want, tol=TOL, path=""):
    np.testing.assert_allclose(np.asarray(interop.to_numpy(got), np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=path)


def _same_tree(got, want):
    """Equal keys, shapes and dtypes; floats within 1e-5, the rest
    equal."""
    def walk(b, a, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(b[k], a[k], f"{path}.{k}")
            return
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path
        if a.dtype.kind == "f":
            _close(b, a, path=path)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)

    walk(interop.to_numpy(got), interop.to_numpy(want), "state")


def _setup(arch):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).replace(
        dtype="float32")
    tcfg = configs.reduced(configs.get_config(arch)).replace(dtype="float32")
    jctx, tctx = jsharding.local_context(), sharding.local_context()
    jp = jmodel.init_params(jax.random.key(0), jcfg, jctx)
    tp = interop.lm_params_from_numpy(interop.to_numpy(jp), CPU)
    return jcfg, tcfg, jctx, tctx, jp, tp


def _tokens(cfg, b, s, seed=1):
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_apply_matches_jax(arch):
    """Layer 0, stateless and prefilling a fresh decode state (ring cache,
    recurrent state, token shifts)."""
    jcfg, tcfg, jctx, tctx, jp, tp = _setup(arch)
    jplan, tplan = jtf.plan_for(jcfg, jctx), tf.plan_for(tcfg, tctx)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    tl = tf.layer(tp["layers"], 0)
    x = np.random.default_rng(2).normal(
        size=(2, S, jcfg.d_model)).astype(np.float32)
    jpos = jmodel._positions_for(jcfg, jnp.zeros((2, S), jnp.int32))
    tpos = model._positions_for(tcfg, torch.zeros((2, S), dtype=torch.int32))
    yj, _, _ = jtf.block_apply(jl, jnp.asarray(x), jcfg, jplan, jctx, jpos,
                               chunk=8)
    yt, st = tf.block_apply(tl, torch.from_numpy(x), tcfg, tplan, tctx, tpos,
                            chunk=8)
    assert st is None
    _close(yt, yj)
    jst = jtf.layer_state_zeros(jcfg, jplan, 2, 16)
    tst = tf.layer_state_zeros(tcfg, tplan, 2, 16, CPU)
    _same_tree(tst, jst)
    yj, jst, _ = jtf.block_apply(jl, jnp.asarray(x), jcfg, jplan, jctx, jpos,
                                 jst, chunk=8, gla_chunk=4)
    yt, tst = tf.block_apply(tl, torch.from_numpy(x), tcfg, tplan, tctx,
                             tpos, tst, chunk=8, gla_chunk=4)
    _close(yt, yj)
    _same_tree(tst, jst)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Prefill of 2 prompts into a 16-slot state (hymba's ring is its
    window of 8), then 8 greedy decode steps: logits and every layer state
    within 1e-5, equal tokens."""
    jcfg, tcfg, jctx, tctx, jp, tp = _setup(arch)
    toks = _tokens(jcfg, 2, S)
    jst = jmodel.make_decode_state(jcfg, jctx, 2, 16)
    tst = model.make_decode_state(tcfg, tctx, 2, 16, CPU)
    jst, jl = jmodel.prefill(jp, jnp.asarray(toks), jst, jcfg, jctx, chunk=8)
    tst, tl = model.prefill(tp, torch.from_numpy(toks), tst, tcfg, tctx,
                            chunk=8)
    _close(tl, jl)
    _same_tree(tst, jst)
    for _ in range(8):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert np.array_equal(nxt, tl.argmax(-1).numpy())
        jst, jl = jmodel.decode_step(jp, jnp.asarray(nxt), jst, jcfg, jctx)
        tst, tl = model.decode_step(tp, torch.from_numpy(nxt), tst, tcfg,
                                    tctx)
        _close(tl, jl)
    _same_tree(tst, jst)


def test_vlm_media_add_matches_jax_and_changes_the_output():
    """Media embeddings at the first M positions of a prefill: JAX's
    logits and states with media, and a change from zero media
    (tests/test_models.py::test_vlm_media_changes_output)."""
    jcfg, tcfg, jctx, tctx, jp, tp = _setup("qwen2-vl-7b")
    assert tcfg.media_tokens == 4
    toks = _tokens(jcfg, 2, S)
    rng = np.random.default_rng(5)
    media = rng.normal(size=(2, tcfg.media_tokens, tcfg.d_model)).astype(
        np.float32)
    out = {}
    for name, m in (("zeros", np.zeros_like(media)), ("media", media)):
        jst, jl = jmodel.prefill(
            jp, jnp.asarray(toks), jmodel.make_decode_state(jcfg, jctx, 2, 16),
            jcfg, jctx, media=jnp.asarray(m), chunk=8)
        tst, tl = model.prefill(
            tp, torch.from_numpy(toks),
            model.make_decode_state(tcfg, tctx, 2, 16, CPU), tcfg, tctx,
            media=torch.from_numpy(m), chunk=8)
        _close(tl, jl)
        _same_tree(tst, jst)
        out[name] = tl
    _, plain = model.prefill(tp, torch.from_numpy(toks),
                             model.make_decode_state(tcfg, tctx, 2, 16, CPU),
                             tcfg, tctx, chunk=8)
    assert torch.equal(plain, out["zeros"])
    assert float((out["media"] - out["zeros"]).abs().max()) > 1e-3


def test_audio_codebook_shapes():
    """(B, S, K) frames in, (B, K, V) logits out of prefill and decode,
    equal to JAX's."""
    jcfg, tcfg, jctx, tctx, jp, tp = _setup("musicgen-large")
    k, vp = tcfg.num_codebooks, tcfg.padded_vocab
    toks = _tokens(tcfg, 2, S)
    assert toks.shape == (2, S, k)
    tst, tl = model.prefill(tp, torch.from_numpy(toks),
                            model.make_decode_state(tcfg, tctx, 2, 16, CPU),
                            tcfg, tctx, chunk=8)
    assert tl.shape == (2, k, vp)
    nxt = tl.argmax(-1).to(torch.int32)
    assert nxt.shape == (2, k)
    tst, tl = model.decode_step(tp, nxt, tst, tcfg, tctx)
    assert tl.shape == (2, k, vp) and tl.dtype == torch.float32
    jst, jl = jmodel.prefill(jp, jnp.asarray(toks),
                             jmodel.make_decode_state(jcfg, jctx, 2, 16),
                             jcfg, jctx, chunk=8)
    jst, jl = jmodel.decode_step(jp, jnp.asarray(nxt.numpy()), jst, jcfg,
                                 jctx)
    _close(tl, jl)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "qwen2.5-14b"])
def test_positions_match_jax(arch):
    """A prompt's positions, (3, B, S) for M-RoPE, and a decoding token's,
    (3, B, 1), equal JAX's."""
    jcfg = jconfigs.get_config(arch)
    tcfg = configs.get_config(arch)
    toks = np.zeros((3, 7), np.int32)
    want = np.asarray(jmodel._positions_for(jcfg, jnp.asarray(toks)))
    got = model._positions_for(tcfg, torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape == ((3, 3, 7) if jcfg.mrope else (3, 7))
    np.testing.assert_array_equal(got, want)
    cur = torch.tensor([0, 5, 9], dtype=torch.int32)
    step = tf.token_positions(tcfg, cur)
    assert step.shape == ((3, 3, 1) if tcfg.mrope else (3, 1))
    assert torch.equal(tf._cur_pos(step), cur)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_params_cross_with_their_dtypes(arch):
    """``interop.lm_params_from_numpy`` carries every family's subtrees
    (tmix, cmix, ssm, the codebook tables) across bit for bit with each
    leaf's dtype, and the port's own init makes the same tree."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = configs.reduced(configs.get_config(arch))
    assert jcfg.dtype == "bfloat16"
    jp = jmodel.init_params(jax.random.key(2), jcfg,
                            jsharding.local_context())
    want = interop.to_numpy(jp)
    got = interop.to_numpy(interop.lm_params_from_numpy(want, CPU))
    mine = interop.to_numpy(model.init_params(0, tcfg,
                                              sharding.local_context(), CPU))

    def walk(a, b, c, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys() == c.keys(), path
            for k in a:
                walk(a[k], b[k], c[k], f"{path}.{k}")
            return
        assert a.dtype == b.dtype == c.dtype and a.shape == c.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=path)

    walk(want, got, mine, "params")
