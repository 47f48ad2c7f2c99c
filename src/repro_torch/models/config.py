"""Model and input-shape configuration of the port (the port's copy of
`repro.models.config`: `ModelConfig` field for field, so a configuration
file reads the same in both packages, and the dry-run's `SHAPES`)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                # 0 => attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // num_heads

    # attention
    attention: str = "gqa"        # gqa | mla | none
    qkv_bias: bool = False
    logit_softcap: Optional[float] = None   # final-logit softcap (gemma2)
    attn_softcap: Optional[float] = None    # attention-logit softcap (gemma2)
    local_window: Optional[int] = None      # sliding window for 'local' blocks
    rope_theta: float = 10000.0

    # layer pattern: repeated until num_layers is covered.
    # kinds: dense | local | global | moe | ssm | ssm_attn (mamba + shared attn)
    layer_pattern: Tuple[str, ...] = ("dense",)

    # MLA (deepseek v2 / minicpm3)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # encoder-decoder (seamless-m4t)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    source_len: int = 4096        # stub audio-frame length (fixed per DESIGN)

    # vlm
    num_patch_tokens: int = 0     # stub patch-embedding length (per batch row)

    # numerics / misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 2048

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def pattern_groups(self) -> int:
        assert self.num_layers % len(self.layer_pattern) == 0, (
            self.name, self.num_layers, self.layer_pattern)
        return self.num_layers // len(self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention: a full-attention
    architecture skips it, as in the JAX package."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True
