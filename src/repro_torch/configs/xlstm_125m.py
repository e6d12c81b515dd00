"""xlstm-125m [ssm] — sLSTM + mLSTM blocks; d_ff=0 (projections live inside
the blocks). [arXiv:2405.04517; unverified]"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_interval=4,      # every 4th block sLSTM, rest mLSTM
    ssm_expand=2,
    max_seq_len=524288,
    act="gelu",
)

REDUCED = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, vocab_size=512,
    max_seq_len=256, compute_dtype="float32",
)
