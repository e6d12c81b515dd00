"""xLSTM LM (xlstm-125m): interleaved mLSTM / sLSTM blocks. Port of
`repro/models/xlstm_model.py`.

Block i is sLSTM when (i+1) % slstm_interval == 0, else mLSTM. Blocks carry
their own projections (the config's d_ff=0) and run as a Python loop, one
parameter dict per block, as in the reference. The serving "cache" is the
constant-size recurrent state: one {"S", "n"} (mLSTM) or {"c", "n", "h"}
(sLSTM) dict of fp32 tensors per block, replaced (not written in place) by
every prefill and decode step. Each mLSTM block makes two
`gated_linear_scan` calls per forward, prefill or decode step.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.configs import ArchConfig
from .common import (
    ParamInit,
    dtype_of,
    embed,
    init_embedding,
    resolve_device,
    rms_norm,
    softmax_cross_entropy,
    unembed,
)
from .ssm import (
    init_mlstm_block,
    init_slstm_block,
    mlstm_forward,
    mlstm_init_state,
    slstm_forward,
    slstm_init_state,
)


def block_kinds(cfg: ArchConfig) -> List[str]:
    k = cfg.slstm_interval
    return [
        "slstm" if (k and (i + 1) % k == 0) else "mlstm" for i in range(cfg.num_layers)
    ]


def init_lm(cfg: ArchConfig, *, seed: int = 0, device=None, dtype=None):
    """Seeded parameters on `device` (None: the current CUDA device, raising
    where there is none; pass ``device="cpu"`` for the CPU): ``{"embed",
    "blocks": [per-block dict], "final_norm"}``, the reference's tree.
    Matrices and biases are stored in `dtype` (default: the config's param
    dtype; every use casts to the compute dtype); norm weights stay fp32."""
    pi = ParamInit(seed, resolve_device(device), dtype or dtype_of(cfg.param_dtype))
    blocks = [init_mlstm_block(pi, cfg) if kind == "mlstm" else init_slstm_block(pi, cfg)
              for kind in block_kinds(cfg)]
    return {
        "embed": init_embedding(pi, cfg.vocab_size, cfg.d_model, tie=cfg.tie_embeddings),
        "blocks": blocks,
        "final_norm": pi.zeros((cfg.d_model,), dtype=torch.float32),
    }


def _run_blocks(cfg: ArchConfig, params, h: torch.Tensor, states):
    new_states = []
    for i, kind in enumerate(block_kinds(cfg)):
        st = states[i] if states is not None else None
        forward = mlstm_forward if kind == "mlstm" else slstm_forward
        h, ns = forward(cfg, params["blocks"][i], h, state=st)
        new_states.append(ns)
    return h, new_states


def lm_forward(cfg: ArchConfig, params, tokens: torch.Tensor):
    """Stateless forward: (logits (B,S,V) in the compute dtype, aux 0)."""
    cd = dtype_of(cfg.compute_dtype)
    h = embed(params["embed"], tokens, compute_dtype=cd)
    h, _ = _run_blocks(cfg, params, h, None)
    h = rms_norm(h, params["final_norm"], eps=cfg.norm_eps)
    logits = unembed(params["embed"], h, tie=cfg.tie_embeddings)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def lm_loss(cfg: ArchConfig, params, tokens: torch.Tensor, labels: torch.Tensor, *,
            z_loss: float = 1e-4, **_):
    logits, _ = lm_forward(cfg, params, tokens)
    loss = softmax_cross_entropy(logits, labels, z_loss=z_loss)
    return loss, {"ce_loss": loss, "moe_aux": torch.zeros_like(loss)}


def init_states(cfg: ArchConfig, batch: int, *, device=None):
    """Zero recurrent states, one dict per block, on `device` (None: the
    current CUDA device)."""
    device = resolve_device(device)
    return [mlstm_init_state(cfg, batch, device=device) if kind == "mlstm"
            else slstm_init_state(cfg, batch, device=device) for kind in block_kinds(cfg)]


def lm_prefill(cfg: ArchConfig, params, tokens: torch.Tensor, states):
    """Forward carrying `states`: (last position's logits (B,V), new states)."""
    cd = dtype_of(cfg.compute_dtype)
    h = embed(params["embed"], tokens, compute_dtype=cd)
    h, new_states = _run_blocks(cfg, params, h, states)
    h = rms_norm(h[:, -1:], params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], h[:, 0], tie=cfg.tie_embeddings), new_states


def lm_decode_step(cfg: ArchConfig, params, states, tokens: torch.Tensor, pos):
    """tokens (B,1) -> (logits (B,V), new states). `pos` is unused: the
    recurrent state is the only context, as in the reference."""
    cd = dtype_of(cfg.compute_dtype)
    h = embed(params["embed"], tokens, compute_dtype=cd)
    h, new_states = _run_blocks(cfg, params, h, states)
    h = rms_norm(h, params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], h[:, 0], tie=cfg.tie_embeddings), new_states
