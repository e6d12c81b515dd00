"""stablelm-12b [dense] — GQA kv=8.
[hf:stabilityai/stablelm-2-1_6b; hf]"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    max_seq_len=4096,
    act="silu",
)

REDUCED = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, d_ff=160,
    vocab_size=512, max_seq_len=256, compute_dtype="float32",
)
