"""h2o-danube-3-4b [dense]: llama+mistral mix, SWA [arXiv:2401.16818;
unverified]. 24L d3840 32H (kv8) d_ff=10240 vocab=32000, window 4096."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense", num_layers=24, d_model=3840,
    num_heads=32, num_kv_heads=8, d_ff=10240, vocab_size=32000,
    sliding_window=4096, rope_theta=10_000.0,
    source="arXiv:2401.16818", remark="llama+mistral mix, SWA",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                         d_ff=128, vocab_size=512, sliding_window=16)
