"""MusicGen-large [audio] — 48L d2048 32H (kv32) ff8192 v2048, decoder-only
over EnCodec tokens (4 codebooks). [arXiv:2306.05284; hf]

The EnCodec frontend is a STUB per the assignment: input_specs() provides
precomputed codebook token frames; the backbone sums codebook embeddings and
predicts all 4 codebooks with separate heads.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    num_codebooks=4, act="gelu",
)
