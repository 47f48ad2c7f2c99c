"""phi4-mini-3.8b [dense]: 32L d=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    head_dim=128,
    layer_pattern=("dense",),
)

SMOKE_CONFIG = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
    vocab_size=128, head_dim=16, vocab_pad_multiple=8)
