"""Architecture hyper-parameters: the JAX package's ``ModelConfig`` with the
same fields and defaults, the four input shapes (``ShapeConfig``,
``SHAPES``) with their applicability rule, the parameter and model-FLOP
counts, and the ``reduced`` test config. Plain dataclass copies, so the
port reads every config file without importing the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (logical, i.e. pre-padding)."""

    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int  # query heads; 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_impl: str = "auto"
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    attn_free: bool = False
    ssm_state: int = 0
    ssm_expand: int = 1
    sliding_window: int = 0  # 0 = full attention
    # --- positional ---
    rope_theta: float = 1e4
    mrope: bool = False  # qwen2-vl M-RoPE (3 position components)
    # --- modality frontend stubs ---
    num_codebooks: int = 0
    media_tokens: int = 0
    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"
    dtype: str = "bfloat16"
    remat: bool = True
    # --- distribution hints ---
    fsdp: bool = False
    notes: str = ""
    # --- performance knobs (defaults = baseline) ---
    decode_mxu_einsum: bool = False  # bf16 dots in ring decode attention
    decode_unroll: int = 1
    decode_appended_kv: bool = False  # read-only ring cache + appended token
    kv_cache_layout: str = "bshd"  # "bshd" or "dot"
    use_pallas_flash: bool = False  # prefill attention through the flash
    #   kernel (csrc/flash_attention.cu here)
    flash_block: int = 512  # kernel block size (q and kv)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128; padded logit columns are
        masked to -1e30 (see layers.lm_head_apply)."""
        return -(-self.vocab_size // 128) * 128

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """An input shape. ``kind`` selects the step: train | prefill |
    decode."""

    name: str
    seq_len: int
    global_batch: int
    kind: str

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

#: archs allowed to run long_500k (sub-quadratic sequence mixing only).
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k only for the ssm and hybrid families; the rest apply to
    every arch."""
    if shape.name == "long_500k":
        return cfg.family in LONG_CONTEXT_FAMILIES
    return True


# ---------------------------------------------------------------------------
# Parameter counting
# ---------------------------------------------------------------------------

def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    n = d * cfg.num_heads * hd  # wq
    n += 2 * d * cfg.num_kv_heads * hd  # wk, wv
    n += cfg.num_heads * hd * d  # wo
    if cfg.qkv_bias:
        n += (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
    return n


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    return 3 * cfg.d_model * d_ff  # swiglu: gate + up + down


def _ssm_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.family == "ssm":  # rwkv6: time-mix + channel-mix
        return 5 * d * d + d * d + 2 * d * cfg.d_ff
    din = cfg.d_model * cfg.ssm_expand  # hymba mamba branch
    return d * 2 * din + din * (2 * cfg.ssm_state + 1) + din * d


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Logical parameter count (embedding + blocks + head)."""
    d = cfg.d_model
    n = cfg.vocab_size * d * max(1, cfg.num_codebooks or 1)  # embeddings
    if not cfg.tie_embeddings:
        n += d * cfg.vocab_size * max(1, cfg.num_codebooks or 1)
    per_layer = 2 * d  # norms
    if not cfg.attn_free:
        per_layer += _attn_params(cfg)
    if cfg.is_moe:
        e = cfg.num_experts_per_tok if active_only else cfg.num_experts
        per_layer += e * _mlp_params(cfg, cfg.d_ff)
        per_layer += d * cfg.num_experts  # router
    elif cfg.family == "ssm":
        per_layer += _ssm_params(cfg)
    else:
        per_layer += _mlp_params(cfg, cfg.d_ff)
    if cfg.family == "hybrid":
        per_layer += _ssm_params(cfg)
    n += cfg.num_layers * per_layer
    n += d  # final norm
    return n


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6 N tokens for training (N the active parameters of
    an MoE), 2 N tokens for a prefill, and 2 N for one token a sequence
    when decoding."""
    n = param_count(cfg, active_only=cfg.is_moe)
    if shape.kind == "decode":
        return 2.0 * n * shape.global_batch
    return (6.0 if shape.kind == "train" else 2.0) * n * shape.tokens


# ---------------------------------------------------------------------------
# Reduced configs for tests
# ---------------------------------------------------------------------------

def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config: few layers, narrow width, small vocab."""
    hd = 8
    heads = 0 if cfg.attn_free else max(2, min(4, cfg.num_heads))
    kv = 0
    if heads:
        # preserve a GQA ratio > 1 when the full config has one
        kv = 1 if cfg.num_kv_heads < cfg.num_heads else heads
    d_model = max(16, heads * hd) if heads else 16
    kw = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=hd,
        d_ff=32,
        vocab_size=128,
        media_tokens=min(cfg.media_tokens, 4),
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        fsdp=False,
        remat=False,
    )
    if cfg.is_moe:
        kw.update(num_experts=4, num_experts_per_tok=2, capacity_factor=16.0)
    if cfg.ssm_state:
        kw.update(ssm_state=4)
    return cfg.replace(**kw)
