"""olmo-1b [dense]: non-parametric LN [arXiv:2402.00838; hf].
16L d2048 16H (kv16) d_ff=8192 vocab=50304."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense", num_layers=16, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=8192, vocab_size=50304,
    norm="nonparam_ln", act="swiglu", tie_embeddings=True, rope_theta=10_000.0,
    source="arXiv:2402.00838", remark="non-parametric LN",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                         d_ff=128, vocab_size=512)
