"""minitron-8b [dense] — pruned nemotron, GQA kv=8.
[arXiv:2407.14679; hf]"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    max_seq_len=4096,
    act="silu",
)

REDUCED = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=512, max_seq_len=256, compute_dtype="float32",
)
