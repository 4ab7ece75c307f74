"""starcoder2-7b [dense]: GQA, RoPE [arXiv:2402.19173; hf].
32L d4608 36H (kv4) d_ff=18432 vocab=49152; LayerNorm + GELU MLP."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", family="dense", num_layers=32, d_model=4608,
    num_heads=36, num_kv_heads=4, d_ff=18432, vocab_size=49152,
    norm="layernorm", act="gelu", rope_theta=100_000.0,
    source="arXiv:2402.19173", remark="GQA, RoPE",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                         d_ff=128, vocab_size=512)
