"""paligemma-3b [vlm] — SigLIP frontend STUB (precomputed patch embeddings)
+ gemma backbone. [arXiv:2407.07726; hf]"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    vision_tokens=256,     # stub 16x16 patch grid
    vision_embed_dim=1152, # SigLIP-So400m width
    max_seq_len=8192,
    rope_theta=10000.0,
    tie_embeddings=True,
    act="gelu",
)

REDUCED = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, vision_tokens=8, vision_embed_dim=32,
    max_seq_len=256, compute_dtype="float32",
)
