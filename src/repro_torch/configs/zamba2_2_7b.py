"""zamba2-2.7b [hybrid]: Mamba2 + shared attn blocks [arXiv:2411.15242; hf].
54 Mamba2 layers d2560, ssm_state=64; one *shared* (single-copy) attention
block (32H kv32, d_ff=10240) applied every 6 mamba layers."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
    num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4, chunk=128),
    shared_attn_every=6,
    source="arXiv:2411.15242", remark="Mamba2 + shared attn blocks",
)

REDUCED = CONFIG.replace(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
                         d_ff=128, vocab_size=512, shared_attn_every=2,
                         ssm=SSMConfig(state_dim=8, head_dim=8, expand=2,
                                       conv_width=4, chunk=8))
