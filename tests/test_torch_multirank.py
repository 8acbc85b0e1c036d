"""The port's multi-device layer across gloo ranks on the CPU, held
against numpy and the JAX package.

Each test spawns its ranks (``parallel.collectives.launch``: ``spawn``
processes, a ``FileStore`` rendezvous, one torch thread a rank) with a
timeout of at most 120 s. JAX's ``shard_map`` references (the SPMD
chain, the EP and TP MoE dispatches, the GPipe pipeline, a checkpoint
saved from 4 devices) run once for the module in one subprocess with 8
forced host devices, as ``tests/test_multidevice.py`` runs them; the
ZeRO-1 step is held against JAX's single-device ``build_train_step`` on
the global batch, in this process."""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_multirank_ranks as ranks
from repro_torch import interop
from repro_torch.core import transaction as tx
from repro_torch.parallel import collectives as coll

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# s: each collective's bound; a launch ends within it plus the 60 s
# rendezvous bound (collectives.INIT_TIMEOUT), so 120 s in all
RANK_TIMEOUT = 60
THREADS = 1


def run_ranks(fn, world, *args, timeout=RANK_TIMEOUT):
    return coll.launch(fn, world, backend="gloo", args=args,
                       timeout=timeout, num_threads=THREADS)


JAX_REFS = r'''
import os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

out = sys.argv[1]
res = {}
devs = np.array(jax.devices())
assert len(devs) == 8, devs

# --- the SPMD chain, 4 replicas on 4 devices, three batches --------------
from repro.core import transaction as tx
cfg = tx.TxConfig(num_keys=64, val_words=2, max_ops=3, chain_len=4,
                  log_capacity=32)
mesh4 = Mesh(devs[:4], ("data",))
rng = np.random.default_rng(0)
w = tx.tx_words(cfg)
batches = []
for _ in range(3):
    batch = np.zeros((6, w), np.int32)
    for i in range(6):
        n = int(rng.integers(1, 4)); batch[i, 0] = n
        for j in range(n):
            base = 1 + j * 3
            batch[i, base] = int(rng.integers(0, 12))  # conflicts
            batch[i, base + 1:base + 3] = rng.integers(0, 9, 2)
    batches.append(batch)
masks = np.array([[1] * 6, [1, 1, 0, 1, 1, 1], [1] * 6], bool)
chain = tx.make_chain(cfg)
chain = jax.device_put(chain, jax.tree_util.tree_map(
    lambda _: NamedSharding(mesh4, P("data")), chain))
for k, (b, m) in enumerate(zip(batches, masks)):
    chain, ack, dfr = tx.chain_commit_spmd(
        chain, jnp.asarray(b), cfg, mesh4, axis="data", mask=jnp.asarray(m),
        kernel_backend="ref")
    res[f"chain/ack{k}"] = np.asarray(ack)
    res[f"chain/deferred{k}"] = np.asarray(dfr)
res["chain/cfg"] = np.array(list(cfg), np.int64)
res["chain/batches"] = np.stack(batches)
res["chain/masks"] = masks
for f in chain._fields:
    res[f"chain/final/{f}"] = np.asarray(getattr(chain, f))

# --- MoE: EP and TP shard_map on (2, 4), with and without drops ----------
from repro.configs import get_config, reduced
from repro.models import moe as moe_mod
from repro.parallel.sharding import ParallelContext
mesh = Mesh(devs.reshape(2, 4), ("data", "model"))
specs = {
    "ep": {"router": P(), "w_gate": P("model", None, None),
           "w_in": P("model", None, None), "w_out": P("model", None, None)},
    "tp": {"router": P(), "w_gate": P(None, None, "model"),
           "w_in": P(None, None, "model"), "w_out": P(None, "model", None)},
}
for cf in (16.0, 1.0):
    c = reduced(get_config("qwen3-moe-30b-a3b")).replace(
        dtype="float32", num_experts=8, num_experts_per_tok=2, d_model=16,
        d_ff=8, capacity_factor=cf)
    params = moe_mod.moe_init(jax.random.key(0), c)
    x = jax.random.normal(jax.random.key(1), (4, 64, 16), jnp.float32)
    pre = f"moe/cf{cf}/"
    for k, v in params.items():
        res[pre + "params/" + k] = np.asarray(v)
    res[pre + "x"] = np.asarray(x)
    xx = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
    for kind in ("ep", "tp"):
        ctx = ParallelContext(mesh=mesh, use_ep=kind == "ep")
        pp = jax.device_put(params, {k: NamedSharding(mesh, s)
                                     for k, s in specs[kind].items()})
        fn = (moe_mod.moe_apply_ep_shardmap if kind == "ep"
              else moe_mod.moe_apply_tp_shardmap)
        y, aux = jax.jit(lambda pr, xv: fn(pr, xv, c, ctx))(pp, xx)
        res[pre + kind + "/y"] = np.asarray(y)
        res[pre + kind + "/aux"] = np.asarray(aux)

# --- GPipe pipeline on (2, 2, 2) ------------------------------------------
from repro.models import transformer as tf
from repro.parallel.pipeline import pipeline_apply
mesh3 = Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))
pctx = ParallelContext(mesh=mesh3, pod_axis="pod")
pcfg = reduced(get_config("deepseek-7b")).replace(
    dtype="float32", num_layers=4, num_heads=2, num_kv_heads=2,
    head_dim=8, d_model=16, remat=False)
plan = tf.plan_for(pcfg, pctx._replace(mesh=None))
layers = tf.stack_init(jax.random.key(0), pcfg, plan)
x = jax.random.normal(jax.random.key(1), (8, 8, 16), jnp.float32)
pos = jnp.arange(8)[None, :]
layers_sh = jax.device_put(layers, jax.tree_util.tree_map(
    lambda l: NamedSharding(mesh3, P("pod", *([None] * (l.ndim - 1)))),
    layers))
x_sh = jax.device_put(x, NamedSharding(mesh3, P("data", None, None)))
y = pipeline_apply(layers_sh, x_sh, pcfg, pctx, pos, microbatches=2,
                   chunk=8)
for path, leaf in jax.tree_util.tree_flatten_with_path(layers)[0]:
    res["pp/layers/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
res["pp/x"] = np.asarray(x)
res["pp/y"] = np.asarray(y)

# --- a checkpoint saved from a 4-device mesh ------------------------------
from repro.checkpoint import save
mesh4m = Mesh(devs[:4], ("model",))
wfull = jnp.arange(32.0).reshape(8, 4)
save(os.path.join(out, "ckpt"), 1,
     {"w": jax.device_put(wfull, NamedSharding(mesh4m, P("model", None)))})
res["ckpt/w"] = np.asarray(wfull)

np.savez(os.path.join(out, "refs.npz"), **res)
print("refs OK")
'''


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """The JAX references, one subprocess with 8 forced host devices."""
    out = tmp_path_factory.mktemp("jax_refs")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_REFS),
                          str(out)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def refs(jax_refs):
    return dict(np.load(os.path.join(jax_refs, "refs.npz")))


# ---------------------------------------------------------------------------
# The collectives against numpy
# ---------------------------------------------------------------------------

def _inputs():
    return [ranks.rank_input(r).numpy() for r in range(4)]


def _rank_of(data, model):
    return data * 2 + model


def _want(name, data, model):
    """What each collective gives rank (data, model) of a (2, 2) mesh."""
    xs = _inputs()
    me = xs[_rank_of(data, model)]
    if name == "coords":
        return (data, model)
    if name == "ppermute_swap":
        return xs[_rank_of(data, 1 - model)]
    if name == "ppermute_one":
        return xs[_rank_of(0, model)] if data == 1 else np.zeros_like(me)
    if name == "ppermute_bool":
        return xs[_rank_of(data, 1)] > 103 if model == 0 \
            else np.zeros(me.shape, bool)
    if name == "psum_model":
        return xs[_rank_of(data, 0)] + xs[_rank_of(data, 1)]
    if name == "psum_both":
        return sum(xs)
    if name == "psum_int":
        return (xs[_rank_of(0, model)] + xs[_rank_of(1, model)]).astype(
            np.int32)
    if name == "psum_bf16":  # each term and the sum rounded to bf16
        a, b = (torch.from_numpy(xs[_rank_of(data, j)]).bfloat16().float()
                for j in range(2))
        return (a + b).bfloat16().float().numpy()
    if name == "pmean_data":
        return (xs[_rank_of(0, model)] + xs[_rank_of(1, model)]) / 2
    if name == "all_to_all":
        blocks = [xs[_rank_of(data, j)].reshape(2, 2, 2)[model]
                  for j in range(2)]
        return np.stack(blocks)
    if name == "all_gather0":
        return np.concatenate([xs[_rank_of(i, model)] for i in range(2)], 0)
    if name == "all_gather1":
        return np.concatenate([xs[_rank_of(data, j)] for j in range(2)], 1)
    if name == "psum_scatter0":
        s = xs[_rank_of(data, 0)] + xs[_rank_of(data, 1)]
        return s[model * 2:(model + 1) * 2]
    if name == "psum_scatter1":
        s = xs[_rank_of(0, model)] + xs[_rank_of(1, model)]
        return s[:, data:data + 1]
    raise KeyError(name)


COLLECTIVES = ("coords", "ppermute_swap", "ppermute_one", "ppermute_bool",
               "psum_model", "psum_both", "psum_int", "psum_bf16",
               "pmean_data", "all_to_all", "all_gather0", "all_gather1",
               "psum_scatter0", "psum_scatter1")


@pytest.fixture(scope="module")
def collective_results():
    return run_ranks(ranks.collectives_rank, 4)


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_matches_numpy(collective_results, name):
    for rank, out in enumerate(collective_results):
        data, model = rank // 2, rank % 2
        got, want = out[name], _want(name, data, model)
        if name == "coords":
            assert tuple(got) == want
            continue
        assert got.dtype == np.asarray(want).dtype, (name, got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} r{rank}")


def test_collective_stats_count_payload_bytes(collective_results):
    """Each rank counts its calls and the bytes it handed them: 14 at
    most (psum_both is two all-reduces); a ppermute counts only where the
    rank sends."""
    for rank, out in enumerate(collective_results):
        data, model = rank // 2, rank % 2
        calls = 14
        calls -= (data == 1)  # ppermute_one: only data 0 sends
        calls -= (model == 0)  # ppermute_bool: only model 1 sends
        assert out["stats"]["calls"] == calls, (rank, out["stats"])
        assert out["stats"]["bytes"] > 0


def test_launch_reraises_a_rank_failure():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(ranks.fail_rank, 2, timeout=60)


def test_launch_times_out_and_leaves_no_rank():
    """A rank that never joins fails the launch by its timeout; every
    rank is killed (the launcher's children are gone)."""
    import multiprocessing as mp

    with pytest.raises((TimeoutError, RuntimeError)):
        run_ranks(ranks.hang_rank, 2, timeout=8)
    assert not [p for p in mp.active_children() if p.is_alive()]


def test_launch_refuses_an_unnamed_backend():
    with pytest.raises(ValueError, match="backend"):
        coll.launch(ranks.fail_rank, 2, backend="mpi")


# ---------------------------------------------------------------------------
# The SPMD chain
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chain_results(jax_refs):
    return run_ranks(ranks.chain_rank, 4,
                     os.path.join(jax_refs, "refs.npz"))


def _local_chain(refs):
    cfg = tx.TxConfig(*(int(v) for v in refs["chain/cfg"]))
    chain = tx.make_chain(cfg, "cpu")
    acks, deferred = [], []
    for b, m in zip(refs["chain/batches"], refs["chain/masks"]):
        chain, p, d = tx.chain_commit_local(
            chain, torch.from_numpy(b), cfg, torch.from_numpy(m),
            kernel_backend="ref")
        acks.append(p.numpy())
        deferred.append(d.numpy())
    return interop.to_numpy(chain), acks, deferred


@pytest.mark.parametrize("field", list(tx.ReplicaState._fields))
def test_chain_commit_spmd_replicas_match_local_and_jax(refs, chain_results,
                                                        field):
    """Every rank's replica equals its row of the port's local chain and
    of JAX's SPMD chain, bit for bit, after three batches."""
    local, _, _ = _local_chain(refs)
    for r, (rep, _, _) in enumerate(chain_results):
        np.testing.assert_array_equal(rep[field], local[field][r])
        np.testing.assert_array_equal(rep[field],
                                      refs[f"chain/final/{field}"][r])
        assert rep[field].dtype == refs[f"chain/final/{field}"].dtype


def test_chain_commit_spmd_ack_and_deferred(refs, chain_results):
    """The head's ACK is the tail's proceed = the local chain's committed
    mask = JAX's; the other ranks hold zeros (ppermute); deferred equal
    on every rank."""
    _, l_acks, l_def = _local_chain(refs)
    for k in range(len(l_acks)):
        np.testing.assert_array_equal(chain_results[0][1][k], l_acks[k])
        np.testing.assert_array_equal(chain_results[0][1][k],
                                      refs[f"chain/ack{k}"])
        for r, (_, acks, deferred) in enumerate(chain_results):
            if r:
                assert not acks[k].any()
            np.testing.assert_array_equal(deferred[k], l_def[k])
            np.testing.assert_array_equal(deferred[k],
                                          refs[f"chain/deferred{k}"])
    assert refs["chain/deferred1"].any() or refs["chain/deferred0"].any()


# ---------------------------------------------------------------------------
# MoE shard_map dispatches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [16.0, 1.0])
@pytest.mark.parametrize("kind", ["ep", "tp"])
def test_moe_shardmap_matches_jax(jax_refs, refs, kind, cf):
    """Each rank's rows equal JAX's shard_map output at rtol 2e-4 / atol
    2e-5, equal on every model rank; the aux loss at rtol 1e-4 (the same
    on every rank). cf 1.0 drops assignments at both EP capacities."""
    out = run_ranks(ranks.moe_rank, 8, os.path.join(jax_refs, "refs.npz"),
                    kind, cf)
    pre = f"moe/cf{cf}/{kind}/"
    y_ref, aux_ref = refs[pre + "y"], float(refs[pre + "aux"])
    b_loc = y_ref.shape[0] // 2
    by_data = {}
    for data, model, y, aux in out:
        np.testing.assert_allclose(y, y_ref[data * b_loc:(data + 1) * b_loc],
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(aux, aux_ref, rtol=1e-4)
        if data in by_data:
            np.testing.assert_array_equal(y, by_data[data])
        by_data[data] = y


# ---------------------------------------------------------------------------
# Pipeline, elastic restore
# ---------------------------------------------------------------------------

def test_pipeline_apply_matches_jax(jax_refs, refs):
    """Every (pod, data) rank's rows equal JAX's pipeline output at rtol
    2e-4 / atol 2e-5, the same on both stages."""
    out = run_ranks(ranks.pipeline_rank, 8,
                    os.path.join(jax_refs, "refs.npz"))
    y_ref = refs["pp/y"]
    b_loc = y_ref.shape[0] // 2
    for pod, data, y in out:
        np.testing.assert_allclose(y, y_ref[data * b_loc:(data + 1) * b_loc],
                                   rtol=2e-4, atol=2e-5)
    stage = {(p, d): y for p, d, y in out}
    for d in range(2):
        np.testing.assert_array_equal(stage[(0, d)], stage[(1, d)])


def test_jax_checkpoint_restores_onto_two_ranks(jax_refs, refs):
    """Saved by JAX from 4 devices (P("model", None)), restored onto 2
    gloo ranks by a new spec, P(None, "model"): each rank holds its
    column block, bit for bit, by ``restore`` and ``elastic.resume``."""
    out = run_ranks(ranks.restore_rank, 2, os.path.join(jax_refs, "ckpt"))
    w = refs["ckpt/w"]
    for r, blk, step, res, step2 in out:
        assert step == step2 == 1
        np.testing.assert_array_equal(blk, w[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(res, w[:, 2 * r:2 * r + 2])


# ---------------------------------------------------------------------------
# ZeRO-1 data-parallel training
# ---------------------------------------------------------------------------

STEPS = 2


def _jax_zero1_reference(compress):
    """JAX's single-device train step on the global batch (f32), STEPS
    steps from ``init_params(key(0))``: (initial params, tokens, final
    params, m, v, residuals or None, [(loss, grad norm)])."""
    import jax

    from repro import configs as jconfigs
    from repro.launch import train as jtrain
    from repro.models import model as jmodel
    from repro.optim import adamw as jadamw
    from repro.parallel import compress as jgc
    from repro.parallel.sharding import local_context

    cfg = jconfigs.reduced(jconfigs.get_config("qwen1.5-0.5b")).replace(
        dtype="float32")
    ctx = local_context()
    params = jmodel.init_params(jax.random.key(0), cfg, ctx)
    p0 = interop.to_numpy(params)
    ocfg = jadamw.AdamWConfig()
    opt = jadamw.init(params, ocfg)
    err = jgc.init_error(params) if compress else None
    step = jtrain.build_train_step(cfg, ctx, ocfg, compress=compress, chunk=8)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (STEPS, 4, 16)).astype(np.int32)
    losses = []
    for tk in tokens:
        batch = {"tokens": jax.numpy.asarray(tk),
                 "labels": jax.numpy.asarray(np.roll(tk, -1, axis=1))}
        params, opt, err, m = step(params, opt, err, batch)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    return (p0, tokens, interop.to_numpy(params), interop.to_numpy(opt.m),
            interop.to_numpy(opt.v),
            None if err is None else interop.to_numpy(err), losses)


@pytest.fixture(scope="module")
def zero1_case(tmp_path_factory):
    """JAX's single-device train step on the global batch (f32), two
    steps, and its inputs saved for the ranks."""
    p0, tokens, params, m, v, _, losses = _jax_zero1_reference(False)
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat["params/" + prefix] = node

    walk(p0, "")
    path = tmp_path_factory.mktemp("zero1") / "inputs.npz"
    np.savez(path, tokens=tokens, **flat)
    return str(path), (params, m, v, losses)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _close(got, want, what, tol=1e-5, slack=0.0):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    assert err <= tol * scale + slack, \
        f"{what}: |diff| {err:.3e} > {tol} x {scale:.3e} + {slack:.1e}"


@pytest.fixture(scope="module")
def zero1_results(zero1_case):
    return run_ranks(ranks.zero1_rank, 2, zero1_case[0], False)


def test_zero1_params_match_jax_and_each_other(zero1_case, zero1_results):
    """After two steps, both ranks' params are bit-equal to each other and
    within 1e-5 of each leaf's scale of JAX's single-device step, plus 1%
    of the summed learning rate: Adam moves an element whose gradient is
    within rounding of zero by m / (sqrt(v) + eps), a ratio the gradients'
    last bits decide; a zero-initialised bias is the rate itself in size
    after one step, so that share shows against its scale."""
    want_p = zero1_case[1][0]
    (p0, *_), (p1, *_) = zero1_results
    lr_sum = sum(m["lr"] for m in zero1_results[0][4])
    for (k, a), (_, b), (_, w) in zip(_leaves(p0), _leaves(p1),
                                      _leaves(want_p)):
        np.testing.assert_array_equal(a, b, err_msg=k)
        _close(a, w, k, slack=1e-2 * lr_sum)


def test_zero1_losses_and_norms_match_jax(zero1_case, zero1_results):
    want = zero1_case[1][3]
    for out in zero1_results:
        metrics = out[4]
        assert out[5] == STEPS
        for (loss, gnorm), m in zip(want, metrics):
            np.testing.assert_allclose(m["loss"], loss, rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"], gnorm, rtol=1e-5)


@pytest.mark.parametrize("moment", ["m", "v"])
def test_zero1_moment_blocks_are_slices_of_jax(zero1_case, zero1_results,
                                               moment):
    """Each rank's moment block is its slice (by zero1_spec's dim) of
    JAX's whole moment, within 1e-5 of the leaf's scale; the gathered
    whole m is JAX's."""
    from repro_torch.optim import adamw as tadamw
    from repro_torch.parallel.sharding import Mesh, ParallelContext

    want = zero1_case[1][1 if moment == "m" else 2]
    idx = 1 if moment == "m" else 2
    tparams = interop.lm_params_from_numpy(want, "meta")
    for r, out in enumerate(zero1_results):
        ctx = ParallelContext(mesh=Mesh((2, 1), ("data", "model"), rank=r))
        dims = dict(_leaves(tadamw.zero1_dims(tparams, ctx)))
        split = 0
        for (k, blk), (_, w) in zip(_leaves(out[idx]), _leaves(want)):
            d = dims[k]
            if d is not None:
                n = w.shape[d] // 2
                w = np.take(w, range(r * n, (r + 1) * n), axis=d)
                split += 1
            assert blk.shape == w.shape, k
            _close(blk, w, f"{moment} {k}")
        assert split > 0
        if moment == "m":
            for (k, a), (_, w) in zip(_leaves(out[3]), _leaves(want)):
                _close(a, w, f"whole m {k}")


@pytest.fixture(scope="module")
def zero1_compressed(zero1_case):
    """--compress-grads: JAX's single-device step with ``gc.roundtrip``
    on the whole gradient, and the 2-rank ZeRO-1 step on the same inputs
    (the round trip on each rank's reduced block)."""
    want = _jax_zero1_reference(True)
    return want, run_ranks(ranks.zero1_rank, 2, zero1_case[0], True)


def _block_of(w, d, r, n=2):
    if d is None:
        return w
    k = w.shape[d] // n
    return np.take(w, range(r * k, (r + 1) * k), axis=d)


def test_zero1_with_compression_keeps_ranks_equal(zero1_compressed):
    """--compress-grads: the ranks' params stay bit-equal, the losses and
    norms are JAX's (rtol 1e-5), and each param is within 1e-5 of its
    scale of JAX's, but for the elements whose int8 code flipped: a
    gradient within rounding of a quantization boundary may land one code
    away (the two sum the batch's rows in another order). Those, at most
    1% of a leaf, move by up to Adam's step, 2 x the summed rate."""
    want, out = zero1_compressed
    want_p, losses = want[2], want[6]
    lr_sum = sum(m["lr"] for m in out[0][4])
    for (k, a), (_, b), (_, w) in zip(_leaves(out[0][0]),
                                      _leaves(out[1][0]), _leaves(want_p)):
        np.testing.assert_array_equal(a, b, err_msg=k)
        diff = np.abs(a.astype(np.float64) - w)
        off = diff > 1e-5 * max(float(np.max(np.abs(w))), 1e-30) \
            + 1e-2 * lr_sum
        assert off.mean() <= 0.01, (k, off.mean())
        assert diff.max() <= 2 * lr_sum + 1e-5 * np.abs(w).max(), k
    for o in out:
        for (loss, gnorm), m in zip(losses, o[4]):
            np.testing.assert_allclose(m["loss"], loss, rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"], gnorm, rtol=1e-5)


@pytest.mark.parametrize("what", ["m", "err"])
def test_zero1_compressed_blocks_are_slices_of_jax(zero1_compressed, what):
    """Each rank's first-moment and residual blocks are their slices of
    JAX's whole ones: every block quantized against its whole leaf's
    scale, as one device quantizes the whole gradient. Within 1e-5 of the
    leaf's scale, but for the flipped int8 codes (at most 1% of a leaf),
    which are held to two codes of the larger step's gradient. That code,
    max|g| / 127, is bounded through v: max v >= (1 - b2) b2 max g^2 for
    the gradients of both steps. A residual is at most half a code, so
    its 1e-5 is of the gradient's scale (127 codes), not its own. A scale
    taken from each block alone moves most elements of a leaf by a
    fraction of a code, and fails."""
    from repro_torch.optim import adamw as tadamw
    from repro_torch.parallel.sharding import Mesh, ParallelContext

    want, out = zero1_compressed
    ocfg = tadamw.AdamWConfig()
    want_t = want[3] if what == "m" else want[5]
    idx = 1 if what == "m" else 6
    vmax = {k: float(np.max(w)) for k, w in _leaves(want[4])}
    tparams = interop.lm_params_from_numpy(want[2], "meta")
    for r, o in enumerate(out):
        ctx = ParallelContext(mesh=Mesh((2, 1), ("data", "model"), rank=r))
        dims = dict(_leaves(tadamw.zero1_dims(tparams, ctx)))
        for (k, blk), (_, w) in zip(_leaves(o[idx]), _leaves(want_t)):
            w = _block_of(w, dims[k], r)
            assert blk.shape == w.shape, k
            code = np.sqrt(vmax[k] / ((1 - ocfg.b2) * ocfg.b2)) / 127
            diff = np.abs(blk.astype(np.float64) - w)
            scale = float(np.max(np.abs(w))) if what == "m" else 127 * code
            off = diff > 1e-5 * max(scale, 1e-30)
            assert off.mean() <= 0.01, (what, k, off.mean())
            assert diff.max() <= 2 * code * 1.001 + 1e-12, (what, k)
