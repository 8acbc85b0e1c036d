"""The training data pipeline."""
from repro_torch.data.pipeline import (
    DataConfig, TokenPipeline, batch_for_step,
)

__all__ = ["DataConfig", "TokenPipeline", "batch_for_step"]
