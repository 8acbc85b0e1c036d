"""The cases of ``test_torch_tp.py`` and their per-rank bodies: module-level
functions (the ``spawn`` start method pickles them by name) that import
only torch, numpy and the port. Each rank builds its ``(data, model)``
mesh, takes its blocks of the JAX package's padded-plan params and of
the inputs, runs the port's tensor-parallel model, and returns numpy
arrays to the test."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs import get_config, reduced
from repro_torch.core import engine as eng
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.parallel.sharding import P, param_blocks, shard_block

DENSE, MOE = "qwen2.5-14b", "qwen3-moe-30b-a3b"
BATCH, SEQ = 4, 16  # tokens of every case
CACHE_LEN = 24  # the decode state's ring
DECODE_STEPS = 4
CHUNK = 8

# name -> the arch, the mesh, the config's overrides, the context's
# knobs, and what runs: "fwd" (forward and the loss value) and "decode"
# (prefill, then DECODE_STEPS greedy decode steps)
CASES = {
    "dense_1x2": dict(arch=DENSE, mesh=(1, 2), parts=("fwd", "decode")),
    "dense_1x4": dict(arch=DENSE, mesh=(1, 4), parts=("fwd", "decode")),
    "dense_2x2": dict(arch=DENSE, mesh=(2, 2), parts=("fwd", "decode")),
    "dense_sp_2x2": dict(arch=DENSE, mesh=(2, 2), sp=True, parts=("fwd",)),
    "dense_sp_1x4": dict(arch=DENSE, mesh=(1, 4), sp=True, parts=("fwd",)),
    "moe_ep_1x2": dict(arch=MOE, mesh=(1, 2), ep_shardmap=True,
                       parts=("fwd", "decode")),
    "moe_ep_2x2": dict(arch=MOE, mesh=(2, 2), ep_shardmap=True,
                       parts=("fwd", "decode")),
    "moe_ep_sp_1x2": dict(arch=MOE, mesh=(1, 2), ep_shardmap=True, sp=True,
                          parts=("fwd",)),
    "moe_tp_1x2": dict(arch=MOE, mesh=(1, 2), ep_shardmap=True,
                       cfg={"moe_impl": "tp"}, parts=("fwd", "decode")),
    "moe_gspmd_1x2": dict(arch=MOE, mesh=(1, 2), parts=("fwd", "decode")),
    "moe_gspmd_tp_1x2": dict(arch=MOE, mesh=(1, 2), cfg={"moe_impl": "tp"},
                             parts=("fwd", "decode")),
}
# the dense engine on (1, 2): requests, prompt length, caps
ENGINE = dict(num_queues=2, capacity=8, prompt_len=8, gen_len=6, slots=4,
              admit_per_step=2, cache_len=16)
ENGINE_REQUESTS = 6
MESHES = sorted({c["mesh"] for c in CASES.values()})


def case_config(case):
    """The port's config of a case (the reduced config in f32)."""
    spec = CASES[case]
    return reduced(get_config(spec["arch"])).replace(
        dtype="float32", **spec.get("cfg", {}))


def case_context(case, mesh):
    spec = CASES[case]
    ctx = lmesh.make_context(mesh, case_config(case), sp=spec.get("sp", False))
    return ctx._replace(ep_shardmap=spec.get("ep_shardmap", False))


def inputs(vocab):
    """Every case's tokens and labels, (BATCH, SEQ) int32."""
    rng = np.random.default_rng(7)
    toks = rng.integers(1, vocab, (BATCH, SEQ)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def fed_tokens(vocab):
    """The tokens both sides decode after the prefill, (DECODE_STEPS,
    BATCH) int32: teacher-forced, so each step's logits compare on the
    same context."""
    rng = np.random.default_rng(9)
    return rng.integers(1, vocab, (DECODE_STEPS, BATCH)).astype(np.int32)


def engine_requests(vocab):
    rng = np.random.default_rng(11)
    prompts = rng.integers(1, vocab, (ENGINE_REQUESTS, ENGINE["prompt_len"]))
    caps = rng.integers(1, ENGINE["gen_len"] + 1, ENGINE_REQUESTS)
    return prompts.astype(np.int32), caps.astype(np.int32)


def _unflat(z, prefix):
    tree: dict = {}
    for key in z.files:
        if key.startswith(prefix):
            parts = key[len(prefix):].split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return tree


def _rows(x, mesh):
    """This rank's rows (the data axis) of a whole batch array."""
    t = torch.from_numpy(np.array(x, copy=True))
    return shard_block(t, P("data", *([None] * (t.dim() - 1))), mesh)


def _case(z, mesh, case):
    cfg = case_config(case)
    ctx = case_context(case, mesh)
    params = param_blocks(interop.lm_params_from_numpy(
        _unflat(z, f"{case}/params/"), "cpu"), ctx)
    toks, labels = inputs(cfg.vocab_size)
    tk, lb = _rows(toks, mesh), _rows(labels, mesh)
    out = {}
    with torch.no_grad():
        if "fwd" in CASES[case]["parts"]:
            logits, aux = model.forward(params, tk, cfg, ctx, chunk=CHUNK)
            loss, m = model.loss_fn(params, {"tokens": tk, "labels": lb},
                                    cfg, ctx, chunk=CHUNK)
            out.update(fwd=logits.numpy(), aux=float(aux), loss=float(loss),
                       ce=float(m["ce"]))
        if "decode" in CASES[case]["parts"]:
            st = model.make_decode_state(cfg, ctx, BATCH, CACHE_LEN, "cpu")
            st, last = model.prefill(params, tk, st, cfg, ctx, chunk=CHUNK)
            logits, greedy = [last.numpy()], [last.argmax(-1).numpy()]
            for tok in fed_tokens(cfg.vocab_size):
                st, lg = model.decode_step(params, _rows(tok, mesh), st,
                                           cfg, ctx)
                logits.append(lg.numpy())
                greedy.append(lg.argmax(-1).numpy())
            out.update(decode_logits=np.stack(logits),
                       greedy=np.stack(greedy), k=st.layers["k"].numpy(),
                       v=st.layers["v"].numpy(), pos=st.pos.numpy())
    return out


def tp_rank(rank, world, refs_path, shape, cases):
    """Every case of one mesh on this rank of it: (data, model) coords and
    each case's outputs."""
    torch.set_grad_enabled(False)
    z = np.load(refs_path)
    mesh = lmesh.make_test_mesh(shape, ("data", "model"))
    out = {c: _case(z, mesh, c) for c in cases}
    if shape == (1, 2):
        out["engine"] = _engine(z, mesh)
        out["ties"] = greedy_ties(mesh)
    return mesh.coord("data"), mesh.coord("model"), out


def tie_head(cfg):
    """Head inputs and params whose logits tie across two model ranks'
    vocab shards: row 0 peaks at global column 1 (rank 0) and at rank 1's
    first column; row 1 at two columns of rank 1. Returns (h (2, 1, D),
    the whole params of ``model._head``)."""
    d, half = cfg.d_model, cfg.padded_vocab // 2
    w = torch.zeros((d, cfg.padded_vocab))
    w[0, 1] = w[0, half] = 3.0
    w[1, 0] = 1.0
    w[1, half + 2] = w[1, half + 5] = 5.0
    h = torch.zeros((2, 1, d))
    h[0, 0, 0] = h[1, 0, 1] = 1.0
    return h, {"final_norm": {"scale": torch.ones(d)}, "embed": {},
               "lm_head": {"w": w}}


def greedy_ties(mesh):
    """The engine's greedy tokens of :func:`tie_head`'s logits through the
    tensor-parallel head: this rank's vocab columns, the shards gathered
    by ``collectives.model_gather``."""
    cfg = case_config("dense_1x2")
    ctx = lmesh.make_context(mesh, cfg)
    h, params = tie_head(cfg)
    params["lm_head"]["w"] = shard_block(params["lm_head"]["w"],
                                         P(None, "model"), mesh)
    return eng._argmax(model._head(params, h, cfg, ctx)).numpy()


def _engine(z, mesh):
    """The dense LM engine (``launch.serve.build_engine``) on this rank:
    ENGINE_REQUESTS requests until all complete; the whole engine state."""
    cfg = reduced(get_config(DENSE)).replace(dtype="float32")
    ctx = lmesh.make_context(mesh, cfg)
    params = param_blocks(interop.lm_params_from_numpy(
        _unflat(z, "dense_1x2/params/"), "cpu"), ctx)
    ecfg = eng.LMEngineConfig(**ENGINE)
    step, state = serve.build_engine(cfg, ctx, ecfg, params, "cpu")
    prompts, caps = engine_requests(cfg.vocab_size)
    q = ecfg.num_queues
    for lo in range(0, len(prompts), q):
        n = len(prompts[lo:lo + q])
        state = eng.lm_inject(state, torch.arange(n, dtype=torch.int32),
                              prompts[lo:lo + q], gen_caps=caps[lo:lo + q])
    for _ in range(ENGINE_REQUESTS * ecfg.gen_len):
        state = step(state)
        if int(state.completed) == ENGINE_REQUESTS:
            break
    return interop.to_numpy(state)


# ---------------------------------------------------------------------------
# On the card: ranks that share it (gloo, host-staged)
# ---------------------------------------------------------------------------

def cuda_tp_config():
    """A small bf16 dense config the flash kernel takes (hd 128), whose
    heads split over 2 ranks without padding (8 q / 4 kv: 4 / 2 a
    rank)."""
    return reduced(get_config(DENSE)).replace(
        num_heads=8, num_kv_heads=4, head_dim=128, d_model=512, d_ff=1024,
        vocab_size=1000, use_pallas_flash=True)


CUDA_PROMPTS = (2, 128)  # prompts x tokens (a flash block of 128)
CUDA_STEPS = 3


def cuda_decode(params, cfg, ctx, prompts):
    """prefill (the flash kernel) then CUDA_STEPS greedy decode steps on
    the card: the logits of each step, on the host."""
    st = model.make_decode_state(cfg, ctx, prompts.shape[0],
                                 prompts.shape[1] + CUDA_STEPS, "cuda")
    st, lg = model.prefill(params, prompts, st, cfg, ctx, backend="cuda")
    out = [lg.cpu()]
    for _ in range(CUDA_STEPS):
        st, lg = model.decode_step(params, lg.argmax(-1).to(torch.int32), st,
                                   cfg, ctx)
        out.append(lg.cpu())
    return out


def cuda_decode_rank(rank, world, prompts):
    """This rank's blocks of the seeded params on a (1, world) mesh on the
    card: :func:`cuda_decode`'s logits and the flash launches."""
    from repro_torch.kernels import flash_attention as fa

    torch.cuda.set_device(0)
    torch.set_grad_enabled(False)
    cfg = cuda_tp_config()
    mesh = lmesh.make_test_mesh((1, world), ("data", "model"))
    ctx = lmesh.make_context(mesh, cfg)
    params = param_blocks(model.init_params(3, cfg, ctx, "cuda"), ctx)
    fa.reset_launches()
    logits = cuda_decode(params, cfg, ctx, torch.from_numpy(prompts).cuda())
    return [x.float().numpy() for x in logits], dict(fa.launches)
