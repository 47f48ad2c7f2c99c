"""llama4-scout-17b-16e [moe]: 48L d=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 routed experts top-1 + 1 shared (Llama-4 design).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    layer_pattern=("moe",),
    num_experts=16,
    num_shared_experts=1,
    moe_top_k=1,
    rope_theta=500000.0,
)

SMOKE_CONFIG = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
    vocab_size=128, head_dim=16, num_experts=4, vocab_pad_multiple=8)
