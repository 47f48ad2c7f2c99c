"""llava-next-34b [vlm]: 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Backbone only; the anyres vision frontend is a STUB — input_specs supplies
2880 precomputed patch embeddings (5 tiles x 576) per row.
[hf:llava-hf/llava-v1.6-34b; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    layer_pattern=("dense",),
    num_patch_tokens=2880,
)

SMOKE_CONFIG = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
    vocab_size=128, head_dim=16, num_patch_tokens=8, vocab_pad_multiple=8)
