"""granite-8b [dense]: llama-arch, code [arXiv:2405.04324; hf].
36L d4096 32H (kv8) d_ff=14336 vocab=49152."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense", num_layers=36, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=49152,
    rope_theta=10_000_000.0,
    source="arXiv:2405.04324", remark="llama-arch, code",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                         d_ff=128, vocab_size=512)
