"""zamba2-7b [hybrid]: 81L d=3584 32H (GQA kv=32) d_ff=14336 vocab=32000,
Mamba2 backbone (state=64) + weight-tied shared attention+MLP block applied
every 3rd layer. [arXiv:2411.15242; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    layer_pattern=("ssm", "ssm", "ssm_attn"),
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
)

SMOKE_CONFIG = CONFIG.scaled(
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=4, d_ff=96,
    vocab_size=128, head_dim=16, ssm_state=16, ssm_head_dim=16,
    vocab_pad_multiple=8)
