"""Parallel layout: the head plan, meshes, partition specs and parallel
contexts (``sharding``); the SPMD collectives and the rank launcher
(``collectives``); the GPipe pipeline (``pipeline``); int8 gradient
compression with error feedback (``compress``)."""
from repro_torch.parallel.sharding import (
    HeadPlan, Mesh, NamedSharding, P, ParallelContext, PartitionSpec,
    batch_spec, head_plan, local_context, param_specs, shard, shard_block,
    spec_for_param,
)
