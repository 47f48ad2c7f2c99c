"""deepseek-v2-lite-16b [moe]: 27L d=2048 16H d_ff(expert)=1408
vocab=102400, MLA kv_lora=512, 64 routed experts top-6 + 2 shared.
[arXiv:2405.04434; hf]

Note: the assignment line lists both "64e top-6" and "2 shared+160 routed";
we follow the public model card: 64 routed / top-6 / 2 shared (DESIGN.md
§Arch-applicability). All layers are MoE with the assigned d_ff=1408.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    q_lora_rank=0,          # v2-lite has no q-lora
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    head_dim=128,
    layer_pattern=("moe",),
    num_experts=64,
    num_shared_experts=2,
    moe_top_k=6,
)

SMOKE_CONFIG = CONFIG.scaled(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=48,
    vocab_size=128, kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16,
    v_head_dim=16, head_dim=16, num_experts=8, moe_top_k=2,
    vocab_pad_multiple=8)
