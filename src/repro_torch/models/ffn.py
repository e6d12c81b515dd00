"""Feed-forward layer: the classic (non-gated) MLP of gemma3's ``act="gelu"``.
Port of `repro/models/ffn.py`; the gated SwiGLU variant (``act="silu"``)
belongs to families not ported yet."""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from .common import ParamInit, act_fn


def init_ffn(pi: ParamInit, cfg: ArchConfig):
    if cfg.act == "silu":
        raise NotImplementedError("gated (silu) FFN is not ported yet")
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_up": pi.normal((d, f), fan_in=d),
        "w_down": pi.normal((f, d), fan_in=f),
    }


def ffn(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); weights cast to the activation dtype."""
    cd = x.dtype
    h = act_fn(cfg.act)(x @ p["w_up"].to(cd))
    return h @ p["w_down"].to(cd)
