"""The port's training substrates against the JAX package's: AdamW
(``repro_torch.optim``), the warmup-cosine schedule, int8 gradient
compression, the data pipeline, ``ShapeConfig``/``SHAPES``/
``model_flops``/``shape_applicable``, checkpoints crossing between the two
packages, and the train launcher (``repro_torch.launch.train``). Inputs
are made with numpy from a seed. Data batches, compression round trips,
shapes and FLOP counts are held bit-equal; AdamW within 1e-6 of each
leaf's scale (f32 sums in another order), bf16 moments within one bf16
rounding."""
from __future__ import annotations

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import data as jdata
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.parallel import compress as jgc
from repro.parallel import sharding as jsharding
from repro_torch import checkpoint as ckpt
from repro_torch import configs, data, interop, optim
from repro_torch.launch import train
from repro_torch.models import model
from repro_torch.parallel import compress as gc
from repro_torch.parallel import sharding
from repro_torch.tree import leaves as tree_leaves

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _tree(seed, bf16_param=False):
    """A small params-like tree: 2-D and 1-D leaves, nested; and grads."""
    rng = np.random.default_rng(seed)
    p = {"layers": {"w": rng.normal(size=(3, 4, 5)),
                    "b": rng.normal(size=(3, 5))},
         "embed": {"tok": rng.normal(size=(7, 4))},
         "norm": {"scale": rng.normal(size=(4,))}}
    g = {"layers": {"w": rng.normal(size=(3, 4, 5)) * 0.3,
                    "b": rng.normal(size=(3, 5)) * 0.3},
         "embed": {"tok": rng.normal(size=(7, 4)) * 0.3},
         "norm": {"scale": rng.normal(size=(4,)) * 0.3}}
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), p)
    g = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), g)
    if bf16_param:
        p["embed"]["tok"] = p["embed"]["tok"].astype(jnp.bfloat16)
    return p, g


def _cross(tree):
    return interop.lm_params_from_numpy(interop.to_numpy(tree), CPU)


def _close_tree(got, want, rel, what):
    a, b = interop.to_numpy(want), interop.to_numpy(got)

    def walk(x, y, path):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
            return
        assert x.dtype == y.dtype and x.shape == y.shape, path
        x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
        bound = rel * np.abs(x).max()
        assert np.abs(x - y).max() <= bound, (path, np.abs(x - y).max())

    walk(a, b, what)


# ------------------------------- optimizer ---------------------------------

@pytest.mark.parametrize("state_dtype,clip,step", [
    ("float32", 1e3, 0), ("float32", 1e3, 4), ("bfloat16", 1e3, 2),
    ("float32", 0.5, 0), ("bfloat16", 0.5, 9)])
def test_adamw_update_matches_jax(state_dtype, clip, step):
    """One update from moments already under way (step > 0 draws them):
    params, moments, step and grad norm; with ``clip`` 0.5 the global-norm
    clip is active, at 1e3 it is not."""
    jp, jg = _tree(step + 11, bf16_param=state_dtype == "bfloat16")
    cfg = jadamw.AdamWConfig(state_dtype=state_dtype, grad_clip=clip)
    jopt = jadamw.init(jp, cfg)
    if step:
        rng = np.random.default_rng(step)
        dt = jnp.dtype(state_dtype)
        jopt = jadamw.OptState(
            m=jax.tree_util.tree_map(lambda x: jnp.asarray(
                rng.normal(size=x.shape) * 0.1, dt), jopt.m),
            v=jax.tree_util.tree_map(lambda x: jnp.asarray(
                rng.random(size=x.shape) * 0.01, dt), jopt.v),
            step=jnp.asarray(step, jnp.int32))
    tp, tg = _cross(jp), _cross(jg)
    topt = interop.opt_state_from_numpy(interop.to_numpy(jopt), CPU)
    lr = 3e-3
    jp2, jopt2, jm = jadamw.update(jg, jopt, jp, lr, cfg)
    tp2, topt2, tm = optim.update(tg, topt, tp, lr,
                                  optim.AdamWConfig(*cfg))
    gnorm = float(jm["grad_norm"])
    assert abs(float(tm["grad_norm"]) - gnorm) <= 1e-6 * gnorm
    assert (gnorm > clip) == (clip == 0.5)
    assert int(topt2.step) == int(jopt2.step) == step + 1
    assert topt2.step.dtype == torch.int32
    # bf16 moments: one bf16 rounding of an f32 value within 1e-6
    rel = 2 ** -7 if state_dtype == "bfloat16" else 1e-6
    _close_tree(topt2.m, jopt2.m, rel, "m")
    _close_tree(topt2.v, jopt2.v, rel, "v")
    _close_tree(tp2, jp2, 2 ** -7 if state_dtype == "bfloat16" else 1e-6,
                "params")


def test_global_norm_matches_jax():
    jp, _ = _tree(5, bf16_param=True)
    want = float(jadamw.global_norm(jp))
    assert abs(float(optim.global_norm(_cross(jp))) - want) <= 1e-6 * want


def test_adamw_init_matches_jax():
    jp, _ = _tree(6, bf16_param=True)
    for sd in ("float32", "bfloat16"):
        jopt = jadamw.init(jp, jadamw.AdamWConfig(state_dtype=sd))
        topt = optim.init(_cross(jp), optim.AdamWConfig(state_dtype=sd))
        assert interop.to_numpy(topt.step).dtype == np.int32
        for a, b in ((jopt.m, topt.m), (jopt.v, topt.v)):
            _close_tree(b, a, 0.0, sd)


def test_adamw_minimizes_quadratic():
    """The JAX package's ``test_adamw_minimizes_quadratic``."""
    cfg = optim.AdamWConfig(weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = optim.init(params, cfg)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, opt, _ = optim.update(g, opt, params, 0.05, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_adamw_weight_decay_skips_vectors():
    """Decay only on leaves of two or more dimensions (zero grads: only
    the decay moves a parameter)."""
    cfg = optim.AdamWConfig(weight_decay=0.5)
    params = {"m": torch.ones((2, 2)), "v": torch.ones((3,))}
    opt = optim.init(params, cfg)
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    new, _, _ = optim.update(zeros, opt, params, 0.1, cfg)
    assert torch.allclose(new["m"], torch.full((2, 2), 0.95))
    assert torch.equal(new["v"], params["v"])


def test_adamw_update_takes_a_given_norm():
    """``gnorm=`` replaces the computed global norm in the clip: its own
    norm gives the same bits, twice it (the clip active) half the first
    moment, exactly."""
    cfg = optim.AdamWConfig(grad_clip=0.5)
    jp, jg = _tree(7, bf16_param=False)
    params, grads = _cross(jp), _cross(jg)
    opt = optim.init(params, cfg)
    norm = optim.global_norm(grads)
    assert float(norm) > cfg.grad_clip
    p1, o1, m1 = optim.update(grads, opt, params, 1e-3, cfg)
    p2, o2, m2 = optim.update(grads, opt, params, 1e-3, cfg, gnorm=norm)
    _, o3, m3 = optim.update(grads, opt, params, 1e-3, cfg, gnorm=2 * norm)
    assert float(m2["grad_norm"]) == float(m1["grad_norm"])
    assert float(m3["grad_norm"]) == 2 * float(norm)
    for a, b, c in zip(tree_leaves(o1.m), tree_leaves(o2.m),
                       tree_leaves(o3.m)):
        assert torch.equal(a, b)
        assert torch.equal(c, a / 2)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)


# ------------------------------- schedule ----------------------------------

@pytest.mark.parametrize("step", [0, 50, 100, 5_000, 10_000, 12_000])
def test_warmup_cosine_matches_jax(step):
    """The default schedule, and one with other knobs, at an int and at an
    int32 tensor step."""
    for kw in ({}, dict(peak=1e-3, warmup=10, total=1000, floor=0.0)):
        want = np.asarray(jschedule.warmup_cosine(step, **kw))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = optim.warmup_cosine(s, **kw)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=0)


# --------------------------- gradient compression --------------------------

def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": (rng.normal(size=(6, 5)) * 3).astype(np.float32)},
            "b": (rng.normal(size=(17,)) * 1e-3).astype(np.float32),
            # halves: 127 / 127 = 1 scale, so x / scale hits .5 exactly
            "t": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 0.0],
                          np.float32),
            "z": np.zeros((3,), np.float32)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_roundtrip_bit_equal(seed):
    """Two rounds of error feedback: payloads, scales, residuals and the
    dequantized grads equal bit for bit (round half to even on both)."""
    g = _grads(seed)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), g)
    je, te = jgc.init_error(jg), gc.init_error(tg)
    first = None
    for _ in range(2):
        jq, js, jr = jgc.compress(jg, je)
        tq, ts, tr = gc.compress(tg, te)
        first = first or interop.to_numpy(tq)["t"].tolist()
        for want, got in ((jq, tq), (js, ts), (jr, tr)):
            a, b = interop.to_numpy(want), interop.to_numpy(got)
            for x, y in zip(jax.tree_util.tree_leaves(a),
                            jax.tree_util.tree_leaves(b)):
                assert x.dtype == y.dtype and np.array_equal(x, y)
        jd, je = jgc.roundtrip(jg, je)
        td, te = gc.roundtrip(tg, te)
        for x, y in zip(jax.tree_util.tree_leaves(interop.to_numpy(jd)),
                        jax.tree_util.tree_leaves(interop.to_numpy(td))):
            assert np.array_equal(x, y)
    assert first == [127, 0, 2, 2, 0, -2, 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_blocks_take_the_whole_leafs_scale(seed):
    """Each half of every leaf compressed alone, with ``amax`` giving the
    max over both halves (what a ``pmax`` over two ranks gives), equals
    the whole leaf compressed, bit for bit: payloads, scales, residuals."""
    rng = np.random.default_rng(seed)
    whole = {"a": torch.from_numpy(rng.normal(size=(6, 4)).astype(
                 np.float32)),
             "b": torch.from_numpy(rng.normal(size=(8,)).astype(
                 np.float32) * 3)}
    err = {k: torch.from_numpy(rng.normal(size=v.shape).astype(
        np.float32) * 0.01) for k, v in whole.items()}
    halves = [{k: v.chunk(2)[i] for k, v in t.items()}
              for t in (whole, err) for i in range(2)]
    g0, g1, e0, e1 = halves
    local = [torch.stack([(g[k] + e[k]).abs().max() for k in sorted(g)])
             for g, e in ((g0, e0), (g1, e1))]
    both = torch.maximum(*local)
    q, s, r = gc.compress(whole, err)
    parts = [gc.compress(g, e, amax=lambda mx: both)
             for g, e in ((g0, e0), (g1, e1))]
    for k in whole:
        assert torch.equal(torch.cat([p[0][k] for p in parts]), q[k]), k
        assert torch.equal(parts[0][1][k], s[k]), k
        assert torch.equal(parts[1][1][k], s[k]), k
        assert torch.equal(torch.cat([p[2][k] for p in parts]), r[k]), k


def test_compression_error_feedback_converges():
    """The JAX package's test: the applied updates converge to the true
    gradient sum, the residual stays bounded."""
    g = {"w": torch.tensor([0.3, -0.7, 0.001, 5.0])}
    err = gc.init_error(g)
    applied = torch.zeros(4)
    for _ in range(50):
        deq, err = gc.roundtrip(g, err)
        applied += deq["w"]
    np.testing.assert_allclose(applied.numpy(), (50 * g["w"]).numpy(),
                               rtol=0.02, atol=0.05)
    assert float(err["w"].abs().max()) <= float(g["w"].abs().max())


def test_compressed_bytes_match_jax():
    g = _grads(0)
    assert gc.compressed_bytes(jax.tree_util.tree_map(
        torch.from_numpy, g)) == jgc.compressed_bytes(
        jax.tree_util.tree_map(jnp.asarray, g)) == 30 + 17 + 7 + 3


# ------------------------------ data pipeline -------------------------------

def _shape(s=16, b=8):
    return (dataclasses.replace(jconfigs.SHAPES["train_4k"], seq_len=s,
                                global_batch=b),
            dataclasses.replace(configs.SHAPES["train_4k"], seq_len=s,
                                global_batch=b))


def _cfgs(arch):
    return (jconfigs.reduced(jconfigs.get_config(arch)),
            configs.reduced(configs.get_config(arch)))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "musicgen-large",
                                  "qwen2-vl-7b"])
@pytest.mark.parametrize("hosts", [1, 2])
def test_batch_for_step_matches_jax(arch, hosts):
    """Tokens, labels (codebooks for audio) and media (vlm), every host's
    slice, bit for bit; the slices make up the one-host batch."""
    jcfg, tcfg = _cfgs(arch)
    jsh, tsh = _shape()
    parts = []
    for h in range(hosts):
        want = jdata.batch_for_step(jcfg, jsh, jdata.DataConfig(
            seed=4, num_hosts=hosts, host_id=h), 9)
        got = data.batch_for_step(tcfg, tsh, data.DataConfig(
            seed=4, num_hosts=hosts, host_id=h), 9)
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].dtype == got[k].dtype
            assert np.array_equal(want[k], got[k]), k
        parts.append(got)
    full = data.batch_for_step(tcfg, tsh, data.DataConfig(seed=4), 9)
    assert np.array_equal(full["tokens"],
                          np.concatenate([p["tokens"] for p in parts]))
    assert ("media" in full) == bool(tcfg.media_tokens)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "musicgen-large"])
def test_file_backed_batches_match_jax(arch, tmp_path):
    """The memory-mapped token file variant, codebooks rolled."""
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 10_000, 4096).astype(
        np.int32).tofile(path)
    jcfg, tcfg = _cfgs(arch)
    jsh, tsh = _shape()
    mm = np.memmap(path, dtype=np.int32)
    want = jdata.pipeline._batch_for_step(jcfg, jsh, jdata.DataConfig(), 3,
                                          mm)
    got = data.pipeline._batch_for_step(tcfg, tsh, data.DataConfig(), 3, mm)
    for k in want:
        assert np.array_equal(want[k], got[k]), k


def test_pipeline_prefetch_and_resume():
    """The prefetching iterator resumes at its start step with the batches
    ``batch_for_step`` gives (and JAX's pipeline gives)."""
    jcfg, tcfg = _cfgs("qwen1.5-0.5b")
    jsh, tsh = _shape()
    pipe = data.TokenPipeline(tcfg, tsh, data.DataConfig(seed=3),
                              start_step=5)
    jpipe = jdata.TokenPipeline(jcfg, jsh, jdata.DataConfig(seed=3),
                                start_step=5)
    try:
        for want_step in (5, 6):
            step, batch = next(pipe)
            jstep, jbatch = next(jpipe)
            assert step == jstep == want_step
            assert np.array_equal(batch["tokens"], jbatch["tokens"])
    finally:
        pipe.close()
        jpipe.close()


# ------------------------------- shapes, FLOPs ------------------------------

def test_shapes_match_jax():
    assert configs.SHAPES.keys() == jconfigs.SHAPES.keys()
    for k, s in configs.SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(
            jconfigs.SHAPES[k])
        assert s.tokens == jconfigs.SHAPES[k].tokens
    assert configs.LONG_CONTEXT_FAMILIES == jconfigs.LONG_CONTEXT_FAMILIES


@pytest.mark.parametrize("arch", configs.all_arch_ids())
def test_model_flops_and_applicability_match_jax(arch):
    """Every shape: equal MODEL_FLOPS (full and reduced config) and the
    same long-context rule."""
    for reduce in (False, True):
        tcfg = configs.get_config(arch)
        jcfg = jconfigs.get_config(arch)
        if reduce:
            tcfg, jcfg = configs.reduced(tcfg), jconfigs.reduced(jcfg)
        for name, shape in configs.SHAPES.items():
            jshape = jconfigs.SHAPES[name]
            assert configs.model_flops(tcfg, shape) == \
                jconfigs.model_flops(jcfg, jshape)
            assert configs.shape_applicable(tcfg, shape) == \
                jconfigs.shape_applicable(jcfg, jshape)


# ------------------------------- checkpoints --------------------------------

def _reduced(arch):
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).replace(
        dtype="float32")
    tcfg = configs.reduced(configs.get_config(arch)).replace(
        dtype="float32")
    return jcfg, tcfg, jsharding.local_context(), sharding.local_context()


def _step_batch(cfg, step):
    sh = dataclasses.replace(configs.SHAPES["train_4k"], seq_len=16,
                             global_batch=2)
    return data.batch_for_step(cfg, sh, data.DataConfig(seed=1), step)


def test_jax_checkpoint_restores_into_the_port_and_steps_alike(tmp_path):
    """JAX trains a step and saves {"params", "opt"}; the port restores it
    bit for bit (dtypes kept), and the next step of each agrees: loss,
    grad norm, and params within 2 lr + 1e-4 max|p|."""
    jcfg, tcfg, jctx, tctx = _reduced("qwen1.5-0.5b")
    jp = jmodel.init_params(jax.random.key(1), jcfg, jctx)
    jopt = jadamw.init(jp, jadamw.AdamWConfig())._replace(
        step=jnp.asarray(3, jnp.int32))
    jstep = jtrain.build_train_step(jcfg, jctx, jadamw.AdamWConfig(),
                                    chunk=8)
    batch = _step_batch(tcfg, 0)
    jp, jopt, _, _ = jstep(jp, jopt, None,
                           {k: jnp.asarray(v) for k, v in batch.items()})
    jckpt.save(str(tmp_path), 4, {"params": jp, "opt": jopt})
    tp0 = model.init_params(0, tcfg, tctx, CPU)
    like = {"params": tp0, "opt": optim.init(tp0, optim.AdamWConfig())}
    assert ckpt.latest_step(str(tmp_path)) == 4
    tree, step = ckpt.restore(str(tmp_path), 4, like)
    assert step == 4
    want = interop.to_numpy({"params": jp, "opt": jopt})
    got = interop.to_numpy(tree)
    for x, y in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    batch = _step_batch(tcfg, 1)
    jp2, jopt2, _, jm = jstep(jp, jopt, None,
                              {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = train.build_train_step(tcfg, tctx, optim.AdamWConfig(), chunk=8)
    tp2, topt2, _, tm = tstep(tree["params"], tree["opt"], None,
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k]))
    lr = float(jm["lr"])
    assert lr > 0 and int(topt2.step) == int(jopt2.step) == 5
    for x, y in zip(jax.tree_util.tree_leaves(interop.to_numpy(jp2)),
                    jax.tree_util.tree_leaves(interop.to_numpy(tp2))):
        assert np.abs(x - y).max() <= 2 * lr + 1e-4 * np.abs(x).max()


def test_port_checkpoint_restores_into_jax(tmp_path):
    """The other way: the port's {"params", "opt"} (bf16 params and
    moments) restored by the JAX package, bit for bit."""
    cfg = configs.reduced(configs.get_config("qwen1.5-0.5b"))
    tp = model.init_params(2, cfg, sharding.local_context(), CPU)
    topt = optim.init(tp, optim.AdamWConfig(state_dtype="bfloat16"))
    ckpt.save(str(tmp_path), 7, {"params": tp, "opt": topt})
    jcfg = jconfigs.reduced(jconfigs.get_config("qwen1.5-0.5b"))
    jp = jmodel.init_params(jax.random.key(0), jcfg,
                            jsharding.local_context())
    jlike = {"params": jp, "opt": jadamw.init(
        jp, jadamw.AdamWConfig(state_dtype="bfloat16"))}
    tree, step = jckpt.restore(str(tmp_path), 7, jlike)
    assert step == 7
    for x, y in zip(jax.tree_util.tree_leaves(interop.to_numpy(tree)),
                    jax.tree_util.tree_leaves(interop.to_numpy(
                        {"params": tp, "opt": topt}))):
        assert x.dtype == y.dtype and np.array_equal(x, y)


# ------------------------------- launcher -----------------------------------

def test_launcher_runs_and_resumes(tmp_path, capsys):
    """``main`` on the CPU trains, checkpoints, and a second call resumes
    from the last committed step."""
    args = ["--device", "cpu", "--seq-len", "16", "--batch", "2",
            "--ckpt-every", "2", "--log-every", "1",
            "--ckpt-dir", str(tmp_path)]
    loss = train.main(["--steps", "4", *args])
    out = capsys.readouterr().out
    assert "[done] 4 steps" in out and np.isfinite(loss)
    assert ckpt.latest_step(str(tmp_path)) == 3
    train.main(["--steps", "2", *args])
    out = capsys.readouterr().out
    assert "[resume] restored step 3" in out
    assert "step     4 loss" in out and "checkpoint at step 4" in out


def test_launcher_with_grad_compression(tmp_path, capsys):
    loss = train.main(["--device", "cpu", "--arch", "deepseek-7b",
                       "--steps", "3", "--seq-len", "16", "--batch", "2",
                       "--ckpt-every", "0", "--ckpt-dir", str(tmp_path),
                       "--compress-grads"])
    assert "[done] 3 steps" in capsys.readouterr().out and np.isfinite(loss)


def test_launcher_dense_100m(tmp_path, capsys):
    """The example driver's ~100M-parameter model, one short step."""
    train.main(["--device", "cpu", "--arch", "dense-100m", "--steps", "1",
                "--seq-len", "8", "--batch", "1", "--ckpt-every", "0",
                "--ckpt-dir", str(tmp_path)])
    assert "[done] 1 steps" in capsys.readouterr().out
    assert configs.param_count(train.DENSE_100M) == configs.param_count(
        jconfigs.base.ModelConfig(**{
            f.name: getattr(train.DENSE_100M, f.name)
            for f in dataclasses.fields(train.DENSE_100M)}))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_training_example_imports_neither_jax_nor_repro():
    path = ROOT / "examples" / "train_lm_torch.py"
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_importing_the_training_path_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.launch.train, repro_torch.optim\n"
            "import repro_torch.data, repro_torch.parallel.compress\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)
