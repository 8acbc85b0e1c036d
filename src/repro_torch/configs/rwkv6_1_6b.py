"""RWKV6-1.6B (Finch) [ssm] — 24L d2048 attn-free ff7168 v65536,
data-dependent decay. [arXiv:2404.05892; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=7168, vocab_size=65536,
    attn_free=True, head_dim=64, ssm_state=64,  # wkv head dim
)
