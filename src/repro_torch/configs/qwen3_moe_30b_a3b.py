"""Qwen3-MoE-30B-A3B [moe] — 48L d2048 32H (GQA kv4) expert-ff768 v151936,
MoE 128e top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

128 experts / 16-way model axis = 8 experts per shard -> EP with all-to-all
dispatch (the ORCA request-routing pattern).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    num_experts=128, num_experts_per_tok=8, moe_impl="ep",
    rope_theta=1e6,
)
