"""Meshes and parallel-context construction — the JAX package's
``repro/launch/mesh.py`` — and the H100's constants for the roofline.

``make_production_mesh`` and ``make_test_mesh`` are functions (importing
this module touches no process group): single-pod ``(16, 16)``
``("data", "model")``, multi-pod ``(2, 16, 16)`` ``("pod", "data",
"model")``. With ``torch.distributed`` up, the mesh is running over the
ranks there are (their number must be the mesh's size): one process group
an axis, from ``torch.distributed.device_mesh.init_device_mesh``, and
this rank's coordinates. Without it the mesh is abstract: it answers
``.shape[axis]`` for the spec functions, as JAX's ``AbstractMesh`` does.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import Mesh, ParallelContext

# --- NVIDIA H100 80GB HBM3 (SXM), per card; the card runs at a 700.00 W
# --- power limit (nvidia-smi), its data sheet's maximum ------------------
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores
HBM_BW = 3.35e12  # B/s, HBM3
NVLINK_BW = 900e9  # B/s per GPU, NVLink 4, both directions together
HBM_BYTES = 80 * 10 ** 9  # 80 GB


def make_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` over ``axes``: running over the process group's
    ranks when ``torch.distributed`` is up, else abstract."""
    shape, axes = tuple(shape), tuple(axes)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(shape, axes)
    world = dist.get_world_size()
    mesh = Mesh(shape, axes, rank=dist.get_rank(),
                backend=dist.get_backend())
    if mesh.size != world:
        raise ValueError(f"a mesh of {mesh.size} ranks {shape} over a "
                         f"world of {world}")
    from torch.distributed.device_mesh import init_device_mesh

    # gloo carries host tensors (CUDA ones are staged through host memory
    # by the collectives), nccl CUDA tensors
    device_type = "cuda" if mesh.backend == "nccl" else "cpu"
    dm = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    mesh.groups = {a: dm.get_group(a) for a in axes}
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """A small mesh for multi-rank tests (spawned gloo ranks on the CPU,
    or ranks that share one card)."""
    return make_mesh(shape, axes)


def make_context(mesh: Optional[Mesh], cfg: Optional[ModelConfig] = None, *,
                 sp: bool = False, pp_stages: int = 1) -> ParallelContext:
    """The parallel context of a mesh and an arch config. MoE takes expert
    parallelism when ``moe_impl`` is ``ep``, or ``auto`` with the experts
    dividing the model axis."""
    axes = list(mesh.axis_names) if mesh is not None else []
    use_ep = False
    fsdp = False
    if cfg is not None:
        fsdp = cfg.fsdp
        if cfg.is_moe and mesh is not None:
            tp = mesh.shape["model"]
            use_ep = cfg.moe_impl == "ep" or (
                cfg.moe_impl == "auto" and cfg.num_experts % tp == 0)
    return ParallelContext(
        mesh=mesh,
        data_axes=("data",),
        model_axis="model",
        pod_axis="pod" if "pod" in axes else None,
        fsdp=fsdp,
        use_ep=use_ep,
        sp=sp,
        pp_stages=pp_stages,
    )
