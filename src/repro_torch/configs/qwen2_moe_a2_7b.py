"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. 24L d2048 16H (kv16) d_expert=1408
vocab=151936; shared expert width 4x1408=5632."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=151936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408,
                  num_shared_experts=4, shared_d_ff=5632),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B", remark="4 shared + 60 routed top-4",
)

REDUCED = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                         d_ff=96, vocab_size=512,
                         moe=MoEConfig(num_experts=8, top_k=4, d_expert=96,
                                       num_shared_experts=1, shared_d_ff=128))
