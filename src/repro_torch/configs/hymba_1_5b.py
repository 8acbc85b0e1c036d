"""Hymba-1.5B [hybrid] — 32L d1600 25H (GQA kv5) ff5504 v32001, ssm_state 16,
parallel attn+mamba heads. [arXiv:2411.13676; hf]

Simplifications (documented in DESIGN.md): all attention heads use a 1024-token
sliding window (the SSM branch provides global context); meta-tokens omitted.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_expand=2, sliding_window=1024,
)
