"""The cases of ``test_torch_tp_families.py`` and their per-rank bodies:
the vlm, audio, ssm and hybrid families under Megatron tensor
parallelism on each rank of a ``(1, tp)`` mesh, its blocks of the JAX
package's padded-plan params, the seeded inputs (numpy only, so the JAX
side imports them from here too); numpy arrays back to the test.
Module-level functions (the ``spawn`` start method pickles them by
name) that import only torch, numpy and the port."""
from __future__ import annotations

import numpy as np
import torch

import torch_tp_ranks as tpr
from repro_torch import interop
from repro_torch.configs import get_config, reduced
from repro_torch.core import engine as eng
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.parallel.sharding import param_blocks

VLM, AUDIO, SSM, HYBRID = ("qwen2-vl-7b", "musicgen-large", "rwkv6-1.6b",
                           "hymba-1.5b")
BATCH, SEQ, CACHE_LEN, DECODE_STEPS, CHUNK = 4, 16, 24, 4, 8
# the hybrid at 5 q heads (1 kv): at tp 2 the plan pads them to 6 (3 a
# rank, one of rank 1's masked) and replicates the kv head; a Mamba
# branch of din 128 has 2 state heads, split over the model axis as
# decode_state_specs splits them (the reduced din 64 has 1: whole)
HYBRID_CFG = {"num_heads": 5, "ssm_expand": 4}
# name -> the arch, the mesh, the config's overrides, and what runs:
# "fwd" (forward and the loss value), "decode" (prefill, then
# DECODE_STEPS teacher-forced decode steps), "engine" (the dense engine
# of torch_tp_ranks.ENGINE until its requests complete)
CASES = {
    "vlm_1x2": dict(arch=VLM, mesh=(1, 2),
                    parts=("fwd", "decode", "engine")),
    "audio_1x2": dict(arch=AUDIO, mesh=(1, 2), parts=("fwd", "decode")),
    "ssm_1x2": dict(arch=SSM, mesh=(1, 2),
                    parts=("fwd", "decode", "engine")),
    "hybrid_1x2": dict(arch=HYBRID, mesh=(1, 2), cfg=HYBRID_CFG,
                       parts=("fwd", "decode", "engine")),
    "vlm_1x4": dict(arch=VLM, mesh=(1, 4), parts=("fwd", "decode")),
}
MESHES = sorted({c["mesh"] for c in CASES.values()})


def case_config(case):
    spec = CASES[case]
    return reduced(get_config(spec["arch"])).replace(
        dtype="float32", **spec.get("cfg", {}))


def inputs(cfg):
    """Every case's (tokens, labels, media or None, fed decode tokens):
    tokens (BATCH, SEQ[, K]) int32, media (BATCH, M, D) f32 for the vlm,
    fed (DECODE_STEPS, BATCH[, K]) int32."""
    rng = np.random.default_rng(7)
    k = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    toks = rng.integers(1, cfg.vocab_size, (BATCH, SEQ) + k).astype(np.int32)
    media = None
    if cfg.media_tokens:
        media = (rng.standard_normal((BATCH, cfg.media_tokens, cfg.d_model))
                 * 0.02).astype(np.float32)
    fed = rng.integers(1, cfg.vocab_size,
                       (DECODE_STEPS, BATCH) + k).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1), media, fed


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x, copy=True))


def _case(z, mesh, case):
    cfg = case_config(case)
    ctx = lmesh.make_context(mesh, cfg)
    params = param_blocks(interop.lm_params_from_numpy(
        tpr._unflat(z, f"{case}/params/"), "cpu"), ctx)
    toks, labels, media, fed = (_t(a) for a in inputs(cfg))
    parts = CASES[case]["parts"]
    out = {}
    if "fwd" in parts:
        logits, _ = model.forward(params, toks, cfg, ctx, media=media,
                                  chunk=CHUNK)
        batch = {"tokens": toks, "labels": labels}
        if media is not None:
            batch["media"] = media
        loss, _ = model.loss_fn(params, batch, cfg, ctx, chunk=CHUNK)
        out.update(fwd=logits.numpy(), loss=float(loss))
    if "decode" in parts:
        st = model.make_decode_state(cfg, ctx, BATCH, CACHE_LEN, "cpu")
        st, last = model.prefill(params, toks, st, cfg, ctx, media=media,
                                 chunk=CHUNK)
        logits = [last.numpy()]
        for tok in fed:
            st, lg = model.decode_step(params, tok, st, cfg, ctx)
            logits.append(lg.numpy())
        out.update(decode_logits=np.stack(logits),
                   state=interop.to_numpy(st))
    if "engine" in parts:
        out["engine"] = _engine(params, cfg, ctx)
    return out


def _engine(params, cfg, ctx):
    """The dense LM engine on this rank over ``torch_tp_ranks``' requests
    until all complete; the whole engine state."""
    ecfg = eng.LMEngineConfig(**tpr.ENGINE)
    step, state = serve.build_engine(cfg, ctx, ecfg, params, "cpu")
    prompts, caps = tpr.engine_requests(cfg.vocab_size)
    q = ecfg.num_queues
    for lo in range(0, len(prompts), q):
        n = len(prompts[lo:lo + q])
        state = eng.lm_inject(state, torch.arange(n, dtype=torch.int32),
                              prompts[lo:lo + q], gen_caps=caps[lo:lo + q])
    for _ in range(tpr.ENGINE_REQUESTS * ecfg.gen_len):
        state = step(state)
        if int(state.completed) == tpr.ENGINE_REQUESTS:
            break
    return interop.to_numpy(state)


def families_rank(rank, world, params_path, shape, cases):
    """Every case of one mesh on this rank: its model coordinate and each
    case's outputs."""
    torch.set_grad_enabled(False)
    z = np.load(params_path)
    mesh = lmesh.make_test_mesh(shape, ("data", "model"))
    return mesh.coord("model"), {c: _case(z, mesh, c) for c in cases}
