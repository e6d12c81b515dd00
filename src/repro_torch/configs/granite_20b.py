"""granite-20b [dense] — llama-arch code model, MQA (kv=1).
[arXiv:2405.04324; hf]"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    max_seq_len=8192,
    act="gelu",
)

REDUCED = CONFIG.replace(
    num_layers=3, d_model=96, num_heads=6, num_kv_heads=1, d_ff=192,
    vocab_size=512, max_seq_len=256, compute_dtype="float32",
)
