"""PaliGemma-style VLM for serving: a stub SigLIP frontend (precomputed
patch embeddings) projected into the gemma backbone, with prefix-LM
attention: bidirectional within the vision prefix, causal over the text.
Port of `repro/models/vlm.py`.

Cache positions count the vision prefix: a prompt of S text tokens fills
positions 0 .. P + S - 1 (P = ``cfg.vision_tokens``), and decoding goes on
from P + S. The forward and loss (`lm_forward`, `lm_loss`) run the same
backbone with the prefix-LM mask over [vision prefix; text] and score the
text positions only.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from . import transformer
from .common import (
    ParamInit,
    dtype_of,
    embed,
    resolve_device,
    rms_norm,
    softmax_cross_entropy,
    unembed,
)


def init_lm(cfg: ArchConfig, *, seed: int = 0, device=None, dtype=None):
    """The backbone's parameters (`transformer.init_lm`, from a second
    stream, as the reference's ``fold_in(key, 1)``) plus ``vision_proj``
    (vision_embed_dim, d_model)."""
    device = resolve_device(device)
    pi = ParamInit(seed, device, dtype or dtype_of(cfg.param_dtype))
    proj = pi.normal((cfg.vision_embed_dim, cfg.d_model), fan_in=cfg.vision_embed_dim)
    params = transformer.init_lm(cfg, seed=seed + 1, device=device, dtype=dtype)
    params["vision_proj"] = proj
    return params


def _embed_multimodal(cfg: ArchConfig, params, tokens: torch.Tensor,
                      patches: torch.Tensor) -> torch.Tensor:
    """[projected patches; token embeddings]: (B, P + S, d)."""
    cd = dtype_of(cfg.compute_dtype)
    h_vis = patches.to(cd) @ params["vision_proj"].to(cd)
    h_txt = embed(params["embed"], tokens, compute_dtype=cd)
    return torch.cat([h_vis, h_txt], dim=1)


def lm_forward(cfg: ArchConfig, params, tokens: torch.Tensor, patches: torch.Tensor):
    """tokens: (B, S_text); patches: (B, P, vision_embed_dim). Returns
    (text-position logits (B, S_text, V), the backbone's aux loss)."""
    P = cfg.vision_tokens
    h = _embed_multimodal(cfg, params, tokens, patches)
    h, aux = transformer.backbone_forward(cfg, params, h, prefix_len=P)
    return unembed(params["embed"], h[:, P:], tie=cfg.tie_embeddings), aux


def lm_loss(cfg: ArchConfig, params, tokens: torch.Tensor, labels: torch.Tensor,
            patches: torch.Tensor, *, z_loss: float = 1e-4, **_):
    """Cross-entropy over the text positions: (loss, {"ce_loss", "moe_aux"})."""
    logits, aux = lm_forward(cfg, params, tokens, patches)
    loss = softmax_cross_entropy(logits, labels, z_loss=z_loss)
    return loss, {"ce_loss": loss, "moe_aux": aux}


def init_states(cfg: ArchConfig, batch: int, max_len: int, *, device=None):
    return transformer.init_caches(cfg, batch, max_len, device=device)


def lm_prefill(cfg: ArchConfig, params, tokens: torch.Tensor, states, patches: torch.Tensor):
    """Prefill over [vision prefix; prompt tokens]. tokens: (B, S); patches:
    (B, P, vision_embed_dim). Returns (last-position logits (B,V), caches)."""
    h = _embed_multimodal(cfg, params, tokens, patches)
    h, caches = transformer.backbone_prefill(cfg, params, h, states, prefix_len=cfg.vision_tokens)
    h = rms_norm(h[:, -1:], params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], h[:, 0], tie=cfg.tie_embeddings), caches


def lm_decode_step(cfg: ArchConfig, params, states, tokens: torch.Tensor, pos):
    return transformer.lm_decode_step(cfg, params, states, tokens, pos)
