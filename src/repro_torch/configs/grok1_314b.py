"""Grok-1-314B [moe] — 64L d6144 48H (GQA kv8) ff32768 v131072, MoE 8e top-2.
[hf:xai-org/grok-1; unverified]

8 experts do not divide the 16-way model axis -> expert-TP (d_ff/16) instead of
EP (see DESIGN.md #Arch-applicability). 628 GB of bf16 params require FSDP over
the data axis in addition to TP.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072,
    num_experts=8, num_experts_per_tok=2, moe_impl="tp",
    fsdp=True,
)
