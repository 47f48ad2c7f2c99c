"""mamba2-780m [ssm]: 48L d=1536, attention-free SSD, state=128, d_ff=0
(no MLP blocks). vocab=50280. [arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    layer_pattern=("ssm",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.scaled(
    num_layers=4, d_model=64, vocab_size=128, ssm_state=16, ssm_head_dim=16,
    vocab_pad_multiple=8)
