"""Feed-forward layers: the classic MLP (gemma3's ``act="gelu"``) and the
gated SwiGLU (``act="silu"``: ``silu(x @ w_gate) * (x @ w_up)``, zamba2's
shared block). Port of `repro/models/ffn.py`."""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from .common import ParamInit, act_fn


def init_ffn(pi: ParamInit, cfg: ArchConfig):
    d, f = cfg.d_model, cfg.d_ff
    tree = {
        "w_up": pi.normal((d, f), fan_in=d),
        "w_down": pi.normal((f, d), fan_in=f),
    }
    if cfg.act == "silu":  # gated variant
        tree["w_gate"] = pi.normal((d, f), fan_in=d)
    return tree


def ffn(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); weights cast to the activation dtype."""
    cd = x.dtype
    act = act_fn(cfg.act)
    up = x @ p["w_up"].to(cd)
    if "w_gate" in p:
        h = act(x @ p["w_gate"].to(cd)) * up
    else:
        h = act(up)
    return h @ p["w_down"].to(cd)
