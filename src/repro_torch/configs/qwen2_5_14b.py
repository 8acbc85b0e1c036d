"""Qwen2.5-14B [dense] — 48L d5120 40H (GQA kv8) ff13824 v152064, QKV bias.
[hf:Qwen/Qwen2.5-14B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064, qkv_bias=True,
    rope_theta=1e6,
)
