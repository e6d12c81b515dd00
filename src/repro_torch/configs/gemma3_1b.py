"""gemma3-1b [dense] — 5:1 local:global sliding-window, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,          # gemma3 uses wide heads (4*256 > d_model)
    sliding_window=512,
    global_interval=6,     # every 6th layer global, 5:1 local:global
    max_seq_len=131072,
    rope_theta=1000000.0,
    tie_embeddings=True,
    act="gelu",
)

REDUCED = CONFIG.replace(
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, sliding_window=16, max_seq_len=256,
    compute_dtype="float32",
)
