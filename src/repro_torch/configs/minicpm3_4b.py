"""minicpm3-4b [dense]: 62L d=2560 40H d_ff=6400 vocab=73448, MLA
(kv_lora=256, q_lora=768 per the public model).
[hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attention="mla",
    kv_lora_rank=256,
    q_lora_rank=768,
    rope_head_dim=32,
    nope_head_dim=64,
    v_head_dim=64,
    head_dim=64,
    layer_pattern=("dense",),
)

SMOKE_CONFIG = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=96,
    vocab_size=128, kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
    nope_head_dim=16, v_head_dim=16, head_dim=16, vocab_pad_multiple=8)
