"""Parallel layout: the head plan and a single-device context; int8
gradient compression with error feedback (``compress``)."""
from repro_torch.parallel.sharding import (
    HeadPlan, ParallelContext, head_plan, local_context, shard,
)
