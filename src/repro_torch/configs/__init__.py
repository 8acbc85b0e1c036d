from .base import (
    LONG_CONTEXT_FAMILIES,
    ModelConfig,
    SHAPES,
    ShapeConfig,
    model_flops,
    param_count,
    reduced,
    shape_applicable,
)
from .registry import ARCH_IDS, all_arch_ids, get_config

__all__ = [
    "ARCH_IDS", "LONG_CONTEXT_FAMILIES", "ModelConfig", "SHAPES",
    "ShapeConfig", "all_arch_ids", "get_config", "model_flops",
    "param_count", "reduced", "shape_applicable",
]
