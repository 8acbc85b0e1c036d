"""The port's partition rules against the JAX package's, exactly, as
tuples: ``make_context``, ``param_specs``, ``state_specs`` (ZeRO-1),
``decode_state_specs`` and ``batch_specs`` on abstract meshes (the
production (16, 16) and (2, 16, 16) with ``pod``, and (4, 2)) for every
registered arch, with and without ``fsdp`` and pipeline stages; and
``abstract_params`` (meta tensors) against JAX's ``eval_shape`` skeleton
at tp 1, 2 and 16. JAX's spec functions run in-process on
``jax.sharding.AbstractMesh``: no devices are needed."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as JP

from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.parallel import sharding as jsharding
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import sharding as tsharding

ARCHS = sorted(jconfigs.ARCH_IDS)
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}
CTX_FIELDS = ("data_axes", "model_axis", "pod_axis", "fsdp", "use_ep",
              "ep_shardmap", "sp", "pp_stages", "tp", "dp", "batch_axes",
              "fsdp_axis")


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), tsharding.Mesh(shape, axes)


def _variants(arch):
    """(jax cfg, port cfg, pp_stages) with and without fsdp and stages."""
    for fsdp in (False, True):
        jc = jconfigs.get_config(arch).replace(fsdp=fsdp)
        tc = tconfigs.get_config(arch).replace(fsdp=fsdp)
        for pp in (1, 2):
            yield jc, tc, pp


def _flat_specs(tree):
    """{path: tuple(spec)} of a JAX spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): tuple(sp) for path, sp in flat}


def _flat_port(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    assert isinstance(tree, tsharding.PartitionSpec), (prefix, tree)
    return {prefix: tuple(tree)}


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch, tp, fsdp=False):
    cfg = jconfigs.get_config(arch).replace(fsdp=fsdp)
    mesh = AbstractMesh((1, tp), ("data", "model"))
    return jmodel.abstract_params(cfg, jmesh.make_context(mesh, cfg))


@functools.lru_cache(maxsize=None)
def _port_abstract(arch, tp, fsdp=False):
    cfg = tconfigs.get_config(arch).replace(fsdp=fsdp)
    mesh = tsharding.Mesh((1, tp), ("data", "model"))
    return tmodel.abstract_params(cfg, tmesh.make_context(mesh, cfg))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_make_context_matches_jax(arch, mesh_name):
    jm, tm = _meshes(mesh_name)
    for jc, tc, pp in _variants(arch):
        for sp in (False, True):
            a = jmesh.make_context(jm, jc, sp=sp, pp_stages=pp)
            b = tmesh.make_context(tm, tc, sp=sp, pp_stages=pp)
            for f in CTX_FIELDS:
                assert getattr(a, f) == getattr(b, f), (arch, pp, sp, f)
            assert tuple(a.axis("data", None)) == tuple(b.axis("data", None))
            assert tuple(jsharding.batch_spec(a, None)) == \
                tuple(tsharding.batch_spec(b, None))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_match_jax(arch, mesh_name):
    """param_specs and the ZeRO-1 state_specs, leaf by leaf."""
    jm, tm = _meshes(mesh_name)
    tp = MESHES[mesh_name][0][-1]
    for jc, tc, pp in _variants(arch):
        jctx = jmesh.make_context(jm, jc, pp_stages=pp)
        tctx = tmesh.make_context(tm, tc, pp_stages=pp)
        jabs = _jax_abstract(arch, tp, jc.fsdp)
        tabs = _port_abstract(arch, tp, tc.fsdp)
        jspecs = jsharding.param_specs(jabs, jctx)
        tspecs = tsharding.param_specs(tabs, tctx)
        assert _flat_specs(jspecs) == _flat_port(tspecs), (arch, jc.fsdp, pp)
        jst = jadamw.state_specs(jspecs, jabs, jctx)
        tst = tadamw.state_specs(tspecs, tabs, tctx)
        assert _flat_specs(jst.m) == _flat_port(tst.m)
        assert _flat_specs(jst.v) == _flat_port(tst.v)
        assert tuple(jst.step) == tuple(tst.step) == ()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_and_batch_specs_match_jax(arch, mesh_name):
    """decode_state_specs at a batch the data axes divide and one they do
    not; batch_specs and input_specs for every shape."""
    jm, tm = _meshes(mesh_name)
    for jc, tc, pp in _variants(arch):
        jctx = jmesh.make_context(jm, jc, pp_stages=pp)
        tctx = tmesh.make_context(tm, tc, pp_stages=pp)
        for batch in (128, 3):
            a = jmodel.decode_state_specs(jc, jctx, batch)
            b = tmodel.decode_state_specs(tc, tctx, batch)
            assert _flat_specs(a.layers) == _flat_port(b.layers)
            assert tuple(a.pos) == tuple(b.pos)
        for name, shape in jconfigs.SHAPES.items():
            tshape = tconfigs.SHAPES[name]
            a = jmodel.batch_specs(jc, shape, jctx)
            b = tmodel.batch_specs(tc, tshape, tctx)
            assert {k: tuple(v) for k, v in a.items()} == \
                {k: tuple(v) for k, v in b.items()}, (arch, name)
            ja = jmodel.input_specs(jc, shape)
            ta = tmodel.input_specs(tc, tshape)
            assert sorted(ja) == sorted(ta)
            for k in ja:
                assert tuple(ja[k].shape) == tuple(ta[k].shape)
                assert np.dtype(ja[k].dtype).name == \
                    str(ta[k].dtype).replace("torch.", "")
                assert ta[k].is_meta


@pytest.mark.parametrize("tp", [1, 2, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_jax_eval_shape(arch, tp):
    """Meta tensors of JAX's shapes and dtypes at each tp's head padding,
    nothing allocated."""
    jabs = jax.tree_util.tree_flatten_with_path(_jax_abstract(arch, tp))[0]
    tabs = _port_abstract(arch, tp)
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            flat[prefix] = node

    walk(tabs, "")
    want = {"/".join(str(k.key) for k in path): leaf for path, leaf in jabs}
    assert sorted(want) == sorted(flat)
    for k, leaf in want.items():
        got = flat[k]
        assert got.is_meta, k
        assert tuple(got.shape) == tuple(leaf.shape), k
        assert jnp.dtype(leaf.dtype).name == \
            str(got.dtype).replace("torch.", ""), k


def test_abstract_params_leave_init_params_unchanged():
    """The meta path draws nothing; the seeded init is the same tree of
    the same shapes, and two seeded inits are bit-equal."""
    cfg = tconfigs.reduced(tconfigs.get_config("qwen1.5-0.5b"))
    ctx = tsharding.local_context()
    a = tmodel.init_params(3, cfg, ctx, device="cpu")
    b = tmodel.init_params(3, cfg, ctx, device="cpu")
    m = tmodel.abstract_params(cfg, ctx)
    from repro_torch.tree import leaves
    for x, y, z in zip(leaves(a), leaves(b), leaves(m)):
        assert torch.equal(x, y)
        assert z.is_meta and z.shape == x.shape and z.dtype == x.dtype


def test_shard_block_and_mesh_coordinates():
    """Row-major coordinates, and a rank's block of an array under a
    spec with a multi-axis entry (major to minor), as JAX lays shards."""
    x = torch.arange(8 * 6).reshape(8, 6)
    spec = tsharding.P(("pod", "data"), "model")
    for rank in range(8):
        mesh = tsharding.Mesh((2, 2, 2), ("pod", "data", "model"), rank=rank)
        pod, data, model = rank // 4, (rank // 2) % 2, rank % 2
        assert (mesh.coord("pod"), mesh.coord("data"),
                mesh.coord("model")) == (pod, data, model)
        blk = tsharding.shard_block(x, spec, mesh)
        r0 = (pod * 2 + data) * 2
        assert torch.equal(blk, x[r0:r0 + 2, model * 3:model * 3 + 3])
    with pytest.raises(ValueError):
        tsharding.shard_block(torch.zeros(3, 2), tsharding.P("data"),
                              tsharding.Mesh((2,), ("data",)))
