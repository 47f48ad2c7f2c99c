"""seamless-m4t-large-v2 [audio]: enc-dec, 24L encoder + 24L decoder,
d=1024 16H (kv=16) d_ff=8192 vocab=256206. The speech frontend is a STUB —
input_specs supplies 4096 precomputed frame embeddings (DESIGN.md §5).
[arXiv:2308.11596; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    layer_pattern=("xdec",),
    is_encoder_decoder=True,
    encoder_layers=24,
    source_len=4096,
)

SMOKE_CONFIG = CONFIG.scaled(
    num_layers=2, encoder_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=96, vocab_size=128, head_dim=16, source_len=24,
    vocab_pad_multiple=8)
