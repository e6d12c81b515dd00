"""kimi-k2-1t-a32b [moe] — trillion-param MoE: 384 experts top-8,
per-expert d_ff=2048 (paper-table config). [arXiv:2501.kimi2; unverified]"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,             # per-expert intermediate dim (paper table)
    vocab_size=163840,
    head_dim=112,          # 64 * 112 = 7168
    num_experts=384,
    experts_per_token=8,
    max_seq_len=131072,
    act="silu",
)

REDUCED = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=512, num_experts=8, experts_per_token=2,
    max_seq_len=256, compute_dtype="float32",
)
