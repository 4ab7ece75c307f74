"""xlstm-125m [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].
12L d_model=768 4H d_ff=0 (xLSTM blocks carry their own projections)
vocab=50304. Alternating mLSTM/sLSTM pairs (slstm_every=2)."""
from .base import ArchConfig, XLSTMConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm", num_layers=12, d_model=768,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304,
    xlstm=XLSTMConfig(num_heads=4, slstm_every=2), tie_embeddings=True,
    source="arXiv:2405.04517", remark="sLSTM + mLSTM blocks",
)

REDUCED = CONFIG.replace(num_layers=4, d_model=64, vocab_size=512,
                         xlstm=XLSTMConfig(num_heads=2, slstm_every=2))
