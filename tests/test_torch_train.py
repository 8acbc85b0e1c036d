"""The port's training path (``repro_torch.models.forward``/``loss_fn``/
``postprocess_grads``, ``attention.tie_kv_grads``, the stack's train mode
with remat, and ``launch.train.build_train_step``) against the JAX
package's, on the reduced f32 configs of every arch. Inputs are made with
numpy from a seed; parameters and optimizer state cross from JAX through
``interop``. Tolerances: the loss within 1e-5 of its size, each gradient
leaf within 1e-4 of its largest |value| (+ 1e-7), the updated parameters
within 2 lr + 1e-4 max|p| (a first AdamW step is about lr sign(g), and a
gradient within noise of zero may flip its sign)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.parallel import compress as jgc
from repro.parallel import sharding as jsharding
from repro_torch import configs, interop
from repro_torch import optim
from repro_torch.launch import train
from repro_torch.models import attention as attn
from repro_torch.models import model
from repro_torch.parallel import compress as gc
from repro_torch.parallel import sharding

CPU = torch.device("cpu")
LOSS_TOL, GRAD_TOL, GRAD_ATOL = 1e-5, 1e-4, 1e-7
B, S = 2, 16


def _setup(arch, **kw):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).replace(
        dtype="float32", **kw)
    tcfg = configs.reduced(configs.get_config(arch)).replace(
        dtype="float32", **kw)
    jctx, tctx = jsharding.local_context(), sharding.local_context()
    jp = jmodel.init_params(jax.random.key(0), jcfg, jctx)
    tp = interop.lm_params_from_numpy(interop.to_numpy(jp), CPU)
    return jcfg, tcfg, jctx, tctx, jp, tp


def _batch(cfg, seed=3, b=B, s=S):
    """{"tokens", "labels"[, "media"]} as numpy, seeded."""
    rng = np.random.default_rng(seed)
    shape = (b, s + 1, cfg.num_codebooks) if cfg.num_codebooks \
        else (b, s + 1)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.media_tokens:
        batch["media"] = (rng.standard_normal(
            (b, cfg.media_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _pairs(a, b, path="grads"):
    """(path, a leaf, b leaf) of two nested dicts of numpy arrays."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}.{k}")
        return
    yield path, np.asarray(a, np.float32), np.asarray(b, np.float32)


def _assert_grads(got, want):
    """Each leaf of ``got`` within GRAD_TOL x max|want| + GRAD_ATOL."""
    for path, w, g in _pairs(interop.to_numpy(want), interop.to_numpy(got)):
        assert w.shape == g.shape, path
        bound = GRAD_TOL * np.abs(w).max() + GRAD_ATOL
        assert np.abs(g - w).max() <= bound, (
            path, float(np.abs(g - w).max()), bound)


def _jax_grads(jp, batch, jcfg, jctx):
    (loss, metrics), grads = jax.value_and_grad(
        jmodel.loss_fn, has_aux=True)(jp, _jax(batch), jcfg, jctx, chunk=8)
    return loss, metrics, grads


@pytest.mark.parametrize("arch", configs.all_arch_ids())
def test_loss_and_grads_match_jax(arch):
    """Every family: media for vlm, codebook frames for audio, the MoE aux
    loss in the total; the loss, its parts and every gradient leaf."""
    jcfg, tcfg, jctx, tctx, jp, tp = _setup(arch)
    batch = _batch(jcfg)
    jl, jm, jg = _jax_grads(jp, batch, jcfg, jctx)
    tl, tm, tg = train.grads_of(tp, _torch(batch), tcfg, tctx, chunk=8)
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    for k in ("ce", "aux"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_TOL * max(
            abs(float(jm[k])), 1e-30), k
    if tcfg.is_moe:
        assert float(tm["aux"]) > 0
    _assert_grads(tg, jg)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "musicgen-large"])
def test_forward_logits_match_jax(arch):
    """The training forward's logits: (B, S, V), or (B, S, K, V) for
    codebook frames, with the media added for vlm."""
    jcfg, tcfg, jctx, tctx, jp, tp = _setup(arch)
    batch = _batch(jcfg)
    jl, jaux = jmodel.forward(jp, jnp.asarray(batch["tokens"]), jcfg, jctx,
                              media=None if "media" not in batch
                              else jnp.asarray(batch["media"]), chunk=8)
    tb = _torch(batch)
    tl, taux = model.forward(tp, tb["tokens"], tcfg, tctx,
                             media=tb.get("media"), chunk=8)
    assert tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-5)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-moe-30b-a3b",
                                  "hymba-1.5b", "rwkv6-1.6b"])
def test_remat_gives_bit_equal_grads(arch):
    """Each layer rematerialised in the backward (torch.utils.checkpoint)
    gives the same bits as keeping its activations."""
    _, tcfg, _, tctx, _, tp = _setup(arch)
    batch = _torch(_batch(tcfg))
    on = train.grads_of(tp, batch, tcfg.replace(remat=True), tctx, chunk=8)
    off = train.grads_of(tp, batch, tcfg.replace(remat=False), tctx, chunk=8)
    assert torch.equal(on[0], off[0])
    for path, a, b in _pairs(interop.to_numpy(on[2]),
                             interop.to_numpy(off[2])):
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("h,kv,tp,bias", [(4, 1, 4, True), (8, 2, 8, False),
                                          (6, 2, 4, True)])
def test_tie_kv_grads_matches_jax(h, kv, tp, bias):
    """Random grads of an L-stacked attention at a plan that replicates kv
    heads (repl > 1): every replica group averaged, as JAX does."""
    jplan = jsharding.head_plan(h, kv, tp)
    tplan = sharding.head_plan(h, kv, tp)
    assert dataclasses.astuple(jplan) == dataclasses.astuple(tplan)
    assert tplan.repl > 1
    rng = np.random.default_rng(h * 100 + kv)
    L, d, hd = 2, 8, 4
    g = {"wq": rng.normal(size=(L, d, tplan.hp, hd)),
         "wk": rng.normal(size=(L, d, tplan.kv_phys, hd)),
         "wv": rng.normal(size=(L, d, tplan.kv_phys, hd)),
         "wo": rng.normal(size=(L, tplan.hp, hd, d))}
    if bias:
        g.update(bq=rng.normal(size=(L, tplan.hp, hd)),
                 bk=rng.normal(size=(L, tplan.kv_phys, hd)),
                 bv=rng.normal(size=(L, tplan.kv_phys, hd)))
    g = {k: v.astype(np.float32) for k, v in g.items()}
    want = jattn.tie_kv_grads({k: jnp.asarray(v) for k, v in g.items()},
                              jplan)
    got = attn.tie_kv_grads({k: torch.from_numpy(v) for k, v in g.items()},
                            tplan)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    grouped = got["wk"].reshape(L, d, tplan.kvp, tplan.repl, hd)
    assert torch.equal(grouped, grouped[:, :, :, :1].expand_as(grouped))


def test_postprocess_grads_ties_only_replicated_plans():
    """At world size 1 the grads pass through untouched; at a tensor-
    parallel degree that replicates kv heads, the attention's kv grads are
    tied (the rest of the tree untouched)."""
    cfg = configs.reduced(configs.get_config("qwen2.5-14b")).replace(
        dtype="float32")
    grads = {"layers": {"attn": {
        "wk": torch.randn(2, 16, 1, 8), "wq": torch.randn(2, 16, 4, 8)}},
        "final_norm": {"scale": torch.randn(16)}}
    one = model.postprocess_grads(grads, cfg, sharding.local_context())
    assert one is grads
    plan = sharding.head_plan(cfg.num_heads, cfg.num_kv_heads, 4)
    assert plan.repl == 4 and plan.kv_phys == 4
    grads["layers"]["attn"]["wk"] = torch.randn(2, 16, 4, 8)
    four = model.postprocess_grads(grads, cfg, sharding.ParallelContext(
        mesh=sharding.Mesh((1, 4), ("data", "model"))))
    want = attn.tie_kv_grads(grads["layers"]["attn"], plan)
    assert torch.equal(four["layers"]["attn"]["wk"], want["wk"])
    assert four["layers"]["attn"]["wq"] is grads["layers"]["attn"]["wq"]
    assert four["final_norm"] is grads["final_norm"]


def _jax_opt_at_step(jp, step, state_dtype="float32"):
    opt = jadamw.init(jp, jadamw.AdamWConfig(state_dtype=state_dtype))
    return opt._replace(step=jnp.asarray(step, jnp.int32))


def _assert_moments(jopt, topt, jerr, terr, clip):
    """The first moments (grad x (1 - b1)) and second (grad^2 x (1 - b2))
    within the grad tolerance (twice it for the square). With compression
    (``jerr`` given) a grad within noise of an int8 rounding boundary may
    land one quantum (the leaf's scale) away: such elements, at most 1% of
    a leaf, are held to one quantum instead (max|m| / 127 for m, the
    square's share of it for v), and so are the residuals (m is the
    clipped grad, so one quantum there is 10 max|m| / 127 / ``clip``)."""
    errs = {} if jerr is None else {
        p: (w, g) for p, w, g in _pairs(interop.to_numpy(jerr),
                                        interop.to_numpy(terr), "m")}
    vs = dict(((p, (w, g)) for p, w, g in _pairs(
        interop.to_numpy(jopt.v), interop.to_numpy(topt.v), "m")))
    for path, m_w, m_g in _pairs(interop.to_numpy(jopt.m),
                                 interop.to_numpy(topt.m), "m"):
        v_w, v_g = vs[path]
        checks = [(m_w, m_g, GRAD_TOL, 1 / 127),
                  (v_w, v_g, 2 * GRAD_TOL, 2 / 127 + 1 / 127 ** 2)]
        for w, g, tol, quantum in checks:
            scale = np.abs(w).max()
            off = np.abs(g - w) > tol * scale + 1e-12
            if jerr is None:
                assert not off.any(), path
            else:
                assert off.mean() <= 0.01, (path, off.mean())
                assert np.abs(g - w).max() <= quantum * scale * 1.001, path
        if path in errs:
            w, g = errs[path]
            bound = 10 / 127 / clip * np.abs(m_w).max() * 1.001 + 1e-12
            assert np.abs(g - w).max() <= bound, path


@pytest.mark.parametrize("arch,compress", [("qwen1.5-0.5b", False),
                                           ("qwen3-moe-30b-a3b", True),
                                           ("hymba-1.5b", False)])
def test_train_step_matches_jax(arch, compress):
    """One ``build_train_step`` from the same params and ``OptState`` (step
    1, so the schedule's rate is warmup_cosine(1)): loss, grad norm and
    rate, the moments (the gradients scaled by 1 - b1 and 1 - b2), and the
    updated params."""
    jcfg, tcfg, jctx, tctx, jp, tp = _setup(arch)
    batch = _batch(jcfg, seed=5)
    jopt = _jax_opt_at_step(jp, 1)
    topt = interop.opt_state_from_numpy(interop.to_numpy(jopt), CPU)
    jerr = jgc.init_error(jp) if compress else None
    terr = gc.init_error(tp) if compress else None
    jp_np = interop.to_numpy(jp)
    jstep = jtrain.build_train_step(jcfg, jctx, jadamw.AdamWConfig(),
                                    compress=compress, chunk=8)
    jp2, jopt2, jerr2, jm = jstep(jp, jopt, jerr, _jax(batch))
    tstep = train.build_train_step(tcfg, tctx, optim.AdamWConfig(),
                                   compress=compress, chunk=8)
    tp2, topt2, terr2, tm = tstep(tp, topt, terr, _torch(batch))

    lr = float(jm["lr"])
    assert lr > 0 and float(tm["lr"]) == lr
    for k in ("loss", "ce", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_TOL * abs(
            float(jm[k])), k
    assert int(topt2.step) == int(jopt2.step) == 2
    clip = min(1.0, 1.0 / max(float(jm["grad_norm"]), 1e-9))
    _assert_moments(jopt2, topt2, jerr2 if compress else None, terr2, clip)
    before = {path: a for path, a, _ in _pairs(jp_np, jp_np)}
    moved = 0
    for path, w, g in _pairs(interop.to_numpy(jp2), interop.to_numpy(tp2)):
        bound = 2 * lr + GRAD_TOL * np.abs(before[path]).max()
        assert np.abs(g - w).max() <= bound, (path, bound)
        moved += not np.array_equal(w, before[path])
    assert moved


def test_opt_state_crosses_with_its_dtypes():
    """bf16 moments and the int32 step keep their dtypes and bits."""
    jcfg, _, jctx, _, jp, _ = _setup("qwen1.5-0.5b")
    jopt = _jax_opt_at_step(jp, 7, "bfloat16")
    jopt = jopt._replace(m=jax.tree_util.tree_map(
        lambda x: (jnp.ones_like(x) * 0.3).astype(jnp.bfloat16), jopt.m))
    topt = interop.opt_state_from_numpy(interop.to_numpy(jopt), CPU)
    assert topt.step.dtype == torch.int32 and int(topt.step) == 7
    assert topt.m["embed"]["tok"].dtype == torch.bfloat16
    for path, a, b in _pairs(interop.to_numpy(jopt.m),
                             interop.to_numpy(topt.m)):
        assert np.array_equal(a, b), path


def test_training_reduces_loss():
    """A few AdamW steps on a tiny model reduce the loss on a fixed batch
    (the JAX package's ``test_training_reduces_loss``)."""
    cfg = configs.reduced(configs.get_config("qwen1.5-0.5b")).replace(
        dtype="float32")
    ctx = sharding.local_context()
    params = model.init_params(0, cfg, ctx, CPU)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    ocfg = optim.AdamWConfig(weight_decay=0.0)
    opt = optim.init(params, ocfg)
    losses = []
    for _ in range(8):
        loss, _, grads = train.grads_of(params, batch, cfg, ctx, chunk=8)
        params, opt, _ = optim.update(grads, opt, params, 1e-2, ocfg)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.5, losses
