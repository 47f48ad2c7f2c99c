"""qwen1.5-110b [dense]: 80L d=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-110B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    layer_pattern=("dense",),
)

SMOKE_CONFIG = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
    vocab_size=128, head_dim=16, vocab_pad_multiple=8)
