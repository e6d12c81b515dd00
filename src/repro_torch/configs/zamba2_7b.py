"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block,
ssm_state=64. [arXiv:2411.15242; unverified]"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,            # shared attention block's MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    shared_attn_interval=6,
    max_seq_len=524288,
    act="silu",
)

REDUCED = CONFIG.replace(
    num_layers=7, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=512, ssm_state=16, shared_attn_interval=3, max_seq_len=256,
    compute_dtype="float32",
)
