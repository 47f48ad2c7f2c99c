"""gemma2-9b [dense]: 42L d=3584 16H (GQA kv=8) d_ff=14336 vocab=256000,
alternating local(window 4096)/global attention, attention + final logit
softcaps. [arXiv:2408.00118; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    layer_pattern=("local", "global"),
    local_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.scaled(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, d_ff=96,
    vocab_size=128, head_dim=16, local_window=16, vocab_pad_multiple=8)
