"""whisper-large-v3 [audio]: enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified]. 32 enc + 32 dec layers, d1280 20H (kv20)
d_ff=5120 vocab=51866; the audio conv frontend is a STUB (input_specs
provides precomputed 1500-frame embeddings); sinusoidal positions so the
backbone lowers at any decode length."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio", num_layers=32, d_model=1280,
    num_heads=20, num_kv_heads=20, d_ff=5120, vocab_size=51866,
    norm="layernorm", act="gelu", tie_embeddings=True,
    encoder_layers=32, encoder_len=1500,
    source="arXiv:2212.04356", remark="enc-dec, conv frontend (stub)",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                         d_ff=128, vocab_size=512, encoder_layers=2,
                         encoder_len=16)
