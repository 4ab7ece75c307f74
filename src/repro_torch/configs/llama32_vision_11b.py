"""llama-3.2-vision-11b [vlm]: cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]. 40L d4096 32H (kv8)
d_ff=14336 vocab=128256; gated cross-attention every 5th layer; the vision
frontend is a STUB (input_specs provides precomputed patch embeddings of
1601 tokens projected to d_model)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm", num_layers=40, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=128256,
    cross_attn_every=5, vision_tokens=1601, rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision", remark="cross-attn image layers",
)

REDUCED = CONFIG.replace(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                         d_ff=128, vocab_size=512, cross_attn_every=2,
                         vision_tokens=16)
