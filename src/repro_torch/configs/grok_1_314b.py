"""grok-1-314b [moe] — 8 experts top-2, GQA kv=8.
[hf:xai-org/grok-1; unverified]"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    num_experts=8,
    experts_per_token=2,
    max_seq_len=8192,
    act="gelu",
)

REDUCED = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=512, num_experts=4, experts_per_token=2, max_seq_len=256,
    compute_dtype="float32",
)
