"""Qwen1.5-0.5B [dense] — 24L d1024 16H (kv16) ff2816 v151936, QKV bias.
[hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=2816, vocab_size=151936, qkv_bias=True,
    rope_theta=1e6, tie_embeddings=True,
)
