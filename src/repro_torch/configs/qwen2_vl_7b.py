"""Qwen2-VL-7B [vlm] — 28L d3584 28H (GQA kv4) ff18944 v152064, M-RoPE.
[arXiv:2409.12191; hf]

The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings that the backbone merges at media positions.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, qkv_bias=True,
    mrope=True, media_tokens=1024, rope_theta=1e6,
)
