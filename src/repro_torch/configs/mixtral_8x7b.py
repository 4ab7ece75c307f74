"""mixtral-8x7b [moe]: 8 experts top-2, SWA [arXiv:2401.04088; hf].
32L d4096 32H (kv8) d_ff=14336 vocab=32000, sliding window 4096."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=32000,
    sliding_window=4096, rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=14336),
    source="arXiv:2401.04088", remark="8 experts top-2, SWA",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                         d_ff=128, vocab_size=512, sliding_window=16,
                         moe=MoEConfig(num_experts=4, top_k=2, d_expert=128))
