"""Architecture configs: the port's own copy of the reference's
`ArchConfig` and `get_config`.

Every architecture id of the reference is known here, but only the ones
whose model family the port runs have a config module; the others raise
`NotImplementedError` until their slice is ported. Each config module
defines ``CONFIG`` (the published configuration) and ``REDUCED`` (a small
same-family config for CPU tests).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | audio | ssm | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (kimi: d_ff IS the expert dim)
    capacity_factor: float = 1.25

    # sliding-window attention (gemma3): every `global_interval`-th layer is
    # global; all others use `sliding_window`.
    sliding_window: int = 0
    global_interval: int = 0

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    slstm_interval: int = 0  # xlstm: every Nth block is sLSTM
    shared_attn_interval: int = 0  # zamba2: shared attn block every Nth layer

    # encoder-decoder (whisper): encoder layers + stub frontend context length
    encoder_layers: int = 0
    encoder_context: int = 0

    # VLM (paligemma): stub patch-embedding prefix
    vision_tokens: int = 0
    vision_embed_dim: int = 0

    max_seq_len: int = 131072
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "gelu"  # gelu | silu (glu variants)

    # numerics policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # execution knobs (hillclimbing surface)
    scan_layers: bool = True
    remat_policy: str = "minimal"  # none | minimal | full
    use_pallas: bool = False  # swap jnp attention for Pallas kernels (TPU)
    # "naive": oracle attention, materializes (Sq, Skv) scores (the
    # paper-faithful baseline kernel). "blocked": flash-style q/kv-chunked
    # online-softmax attention (beyond-paper §Perf optimization).
    attention_impl: str = "naive"
    # SSD/mLSTM chunkwise scan: "vectorized" materializes every chunk's
    # (L, L) gate matrix at once; "sequential" scans chunk-by-chunk.
    ssd_impl: str = "vectorized"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


ARCH_IDS: Sequence[str] = (
    "gemma3-1b",
    "granite-20b",
    "stablelm-12b",
    "minitron-8b",
    "grok-1-314b",
    "kimi-k2-1t-a32b",
    "whisper-small",
    "xlstm-125m",
    "paligemma-3b",
    "zamba2-7b",
)

#: Architectures whose config (and model family) the port runs today.
PORTED_ARCH_IDS: Sequence[str] = ("gemma3-1b", "xlstm-125m")


def get_config(arch_id: str, *, reduced: bool = False) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCH_IDS)}")
    if arch_id not in PORTED_ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet; ported: {list(PORTED_ARCH_IDS)}"
        )
    mod_name = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.REDUCED if reduced else mod.CONFIG
