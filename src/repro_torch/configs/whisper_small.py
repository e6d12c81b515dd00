"""whisper-small [audio] — encoder-decoder; conv/audio frontend is a STUB
(precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from . import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,         # decoder layers (backbone spec)
    encoder_layers=12,
    encoder_context=1500,  # stub: precomputed audio-frame embeddings
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    max_seq_len=32768,     # backbone exercised at assigned shapes
    act="gelu",
)

REDUCED = CONFIG.replace(
    num_layers=2, encoder_layers=2, encoder_context=32, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512, max_seq_len=256,
    compute_dtype="float32",
)
