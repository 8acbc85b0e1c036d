from .base import ModelConfig, param_count, reduced
from .registry import ARCH_IDS, all_arch_ids, get_config

__all__ = ["ARCH_IDS", "ModelConfig", "all_arch_ids", "get_config",
           "param_count", "reduced"]
