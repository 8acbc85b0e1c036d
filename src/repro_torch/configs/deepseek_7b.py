"""DeepSeek-7B [dense] — 30L d4096 32H (kv32) ff11008 v102400, llama-arch.
[arXiv:2401.02954; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=102400,
)
