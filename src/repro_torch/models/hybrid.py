"""zamba2-style hybrid LM: a Mamba2 backbone and one SHARED attention block
(attention + SwiGLU FFN) applied after every `shared_attn_interval` Mamba2
layers. Port of the serving half of `repro/models/hybrid.py`.

The reference stacks the Mamba2 layers for `jax.lax.scan` in groups of
`shared_attn_interval`; the port keeps one parameter dict per layer in plain
lists, in layer order: ``params["mamba"][g * grp + i]`` is layer i of group
grp (the reference's ``mamba`` stack reshaped to (n_groups, g, ...)), and
``params["mamba_tail"]`` holds the layers after the last group. Every
application of the shared block has its OWN full-depth KV cache (same
weights, a different hidden stream), with no window.

Serving state, every leaf batch-first (the slot decoders pack slot s of
each leaf): ``{"mamba": [{"S", "conv"} per layer], "attn": [(k, v) per
group], "mamba_tail": [...]}``. Mamba2 states are replaced by each prefill
and decode step; the KV caches are written in place. The stateless
forward and loss are training-side and come with the training slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs import ArchConfig
from .attention import (
    decode_self_attention,
    init_attention,
    init_kv_cache,
    prefill_attention,
    slot_positions,
)
from .common import ParamInit, dtype_of, embed, init_embedding, resolve_device, rms_norm, unembed
from .ffn import ffn, init_ffn
from .ssm import init_mamba_block, mamba_forward, mamba_init_state


def group_structure(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(interval, n_groups, n_tail_layers)."""
    g = cfg.shared_attn_interval
    return g, cfg.num_layers // g, cfg.num_layers % g


def init_lm(cfg: ArchConfig, *, seed: int = 0, device=None, dtype=None):
    """Seeded parameters on `device` (None: the current CUDA device, raising
    where there is none; pass ``device="cpu"`` for the CPU). Matrices are
    stored in `dtype` (default: the config's param dtype); norm weights and
    the Mamba2 decay parameters stay fp32."""
    pi = ParamInit(seed, resolve_device(device), dtype or dtype_of(cfg.param_dtype))
    g, n_groups, n_tail = group_structure(cfg)
    d = cfg.d_model
    params = {
        "embed": init_embedding(pi, cfg.vocab_size, d, tie=cfg.tie_embeddings),
        "mamba": [init_mamba_block(pi, cfg) for _ in range(n_groups * g)],
        "shared_attn": {
            "ln1": pi.zeros((d,), dtype=torch.float32),
            "attn": init_attention(pi, cfg),
            "ln2": pi.zeros((d,), dtype=torch.float32),
            "ffn": init_ffn(pi, cfg),
        },
        "final_norm": pi.zeros((d,), dtype=torch.float32),
    }
    if n_tail:
        params["mamba_tail"] = [init_mamba_block(pi, cfg) for _ in range(n_tail)]
    return params


def init_states(cfg: ArchConfig, batch: int, max_len: int, *, device=None):
    """Zero serving state on `device` (None: the current CUDA device): a
    Mamba2 state per layer (S fp32, conv window in the compute dtype) and a
    `max_len`-deep (k, v) cache per shared-block application."""
    device = resolve_device(device)
    cd = dtype_of(cfg.compute_dtype)
    g, n_groups, n_tail = group_structure(cfg)

    def mamba(n):
        return [mamba_init_state(cfg, batch, device=device, conv_dtype=cd) for _ in range(n)]

    state = {
        "mamba": mamba(n_groups * g),
        "attn": [init_kv_cache(cfg, batch, max_len, window=0, dtype=cd, device=device)
                 for _ in range(n_groups)],
    }
    if n_tail:
        state["mamba_tail"] = mamba(n_tail)
    return state


def _shared_block(cfg, p, h, attend):
    """The shared attention block around `attend(attn_in) -> (out, cache)`."""
    attn_in = rms_norm(h, p["ln1"], eps=cfg.norm_eps)
    attn_out, cache = attend(attn_in)
    h = h + attn_out
    ffn_in = rms_norm(h, p["ln2"], eps=cfg.norm_eps)
    return h + ffn(cfg, p["ffn"], ffn_in), cache


def _backbone(cfg: ArchConfig, params, h: torch.Tensor, states, attend):
    """Every Mamba2 layer in order, the shared block after each group
    (`attend(p_attn, x, cache)` is its prefill or decode attention).
    Returns (h, new states)."""
    g, n_groups, n_tail = group_structure(cfg)
    shared = params["shared_attn"]
    new = {"mamba": [], "attn": []}
    for grp in range(n_groups):
        for i in range(g):
            layer = grp * g + i
            h, ns = mamba_forward(cfg, params["mamba"][layer], h,
                                  state=states["mamba"][layer])
            new["mamba"].append(ns)
        h, cache = _shared_block(cfg, shared, h,
                                 lambda x: attend(shared["attn"], x, states["attn"][grp]))
        new["attn"].append(cache)
    if n_tail:
        new["mamba_tail"] = []
        for i in range(n_tail):
            h, ns = mamba_forward(cfg, params["mamba_tail"][i], h,
                                  state=states["mamba_tail"][i])
            new["mamba_tail"].append(ns)
    return h, new


def lm_prefill(cfg: ArchConfig, params, tokens: torch.Tensor, states):
    """tokens: (B, S), carrying `states`. Returns (last-position logits
    (B, V), new states)."""
    cd = dtype_of(cfg.compute_dtype)
    h = embed(params["embed"], tokens, compute_dtype=cd)
    h, new = _backbone(cfg, params, h, states,
                       lambda p, x, cache: prefill_attention(cfg, p, x, cache))
    h = rms_norm(h[:, -1:], params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], h[:, 0], tie=cfg.tie_embeddings), new


def lm_decode_step(cfg: ArchConfig, params, states, tokens: torch.Tensor, pos):
    """One decode step. tokens: (B, 1); pos: a scalar shared by the batch
    (the serial engine) or (B,) per-slot positions (the slot decoder).
    Returns (logits (B, V), new states)."""
    cd = dtype_of(cfg.compute_dtype)
    pos = slot_positions(pos, tokens.shape[0], tokens.device)  # once for every group
    h = embed(params["embed"], tokens, compute_dtype=cd)
    h, new = _backbone(cfg, params, h, states,
                       lambda p, x, cache: decode_self_attention(cfg, p, x, cache, pos))
    h = rms_norm(h, params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], h[:, 0], tie=cfg.tie_embeddings), new
