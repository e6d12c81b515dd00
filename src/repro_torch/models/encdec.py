"""Whisper-style encoder-decoder. Port of `repro/models/encdec.py`.

The audio frontend (the mel conv stack) is a stub: inputs are precomputed
frame embeddings (B, encoder_context, d_model). The encoder is
bidirectional self-attention; each decoder layer is causal self-attention
over a dense KV cache, then cross-attention to the encoder output, whose
K/V each layer computes once a request at prefill.

The reference stacks every layer's leaves for `jax.lax.scan`; the port
keeps one dict a layer in ``encoder`` and ``decoder`` lists. The decoder
state is ``{"k", "v", "cross_k", "cross_v"}``, each a list of one batch-first
tensor a layer: the reference broadcasts one zero cache to every layer,
which is harmless where arrays are values, but the port writes caches in
place, so every layer has tensors of its own.

Training (`lm_forward`, `lm_loss`): the teacher-forced decoder over the
whole token sequence, each encoder and decoder layer under the config's
`remat_policy` (`transformer._remat`), as the reference remats its scan
bodies; the cross K/V are computed once for every layer, outside them.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from .attention import (
    cross_attention,
    cross_attention_kv,
    decode_self_attention,
    init_attention,
    init_cross_attention,
    init_kv_cache,
    prefill_attention,
    self_attention,
    slot_positions,
)
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
from .ffn import ffn, init_ffn
from .transformer import _remat


def init_lm(cfg: ArchConfig, *, seed: int = 0, device=None, dtype=None):
    """Seeded parameters on `device` (None: the current CUDA device; pass
    ``device="cpu"`` for the CPU), matrices in `dtype` (default: the config's
    param dtype), norm weights in fp32."""
    pi = ParamInit(seed, resolve_device(device), dtype or dtype_of(cfg.param_dtype))
    d = cfg.d_model

    def norm():
        return pi.zeros((d,), dtype=torch.float32)

    return {
        "embed": init_embedding(pi, cfg.vocab_size, d, tie=cfg.tie_embeddings),
        "enc_pos": pi.normal((cfg.encoder_context, d), fan_in=d),
        "encoder": [
            {"ln1": norm(), "attn": init_attention(pi, cfg), "ln2": norm(),
             "ffn": init_ffn(pi, cfg)}
            for _ in range(cfg.encoder_layers)
        ],
        "enc_norm": norm(),
        "decoder": [
            {"ln1": norm(), "attn": init_attention(pi, cfg), "ln_x": norm(),
             "cross": init_cross_attention(pi, cfg), "ln2": norm(), "ffn": init_ffn(pi, cfg)}
            for _ in range(cfg.num_layers)
        ],
        "final_norm": norm(),
    }


def _encoder_layer(cfg: ArchConfig, p_l, h: torch.Tensor) -> torch.Tensor:
    attn_in = rms_norm(h, p_l["ln1"], eps=cfg.norm_eps)
    h = h + self_attention(cfg, p_l["attn"], attn_in, causal=False)
    ffn_in = rms_norm(h, p_l["ln2"], eps=cfg.norm_eps)
    return h + ffn(cfg, p_l["ffn"], ffn_in)


def encode(cfg: ArchConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, d) stub frame embeddings -> (B, T, d); each layer
    under `remat_policy` (which does nothing with grad mode off: serving)."""
    cd = dtype_of(cfg.compute_dtype)
    h = frames.to(cd) + params["enc_pos"].to(cd)[None]
    for p_l in params["encoder"]:
        h = _remat(cfg, lambda x, p_l=p_l: _encoder_layer(cfg, p_l, x))(h)
    return rms_norm(h, params["enc_norm"], eps=cfg.norm_eps)


def _decoder_cross_kv(cfg: ArchConfig, params, enc_out: torch.Tensor):
    """Each decoder layer's cross K/V: a list of (k, v), each (B, T, KV, hd)."""
    return [cross_attention_kv(cfg, p_l["cross"], enc_out) for p_l in params["decoder"]]


def _decoder_layer(cfg: ArchConfig, p_l, h: torch.Tensor, ck: torch.Tensor,
                   cv: torch.Tensor) -> torch.Tensor:
    attn_in = rms_norm(h, p_l["ln1"], eps=cfg.norm_eps)
    h = h + self_attention(cfg, p_l["attn"], attn_in, causal=True)
    x_in = rms_norm(h, p_l["ln_x"], eps=cfg.norm_eps)
    h = h + cross_attention(cfg, p_l["cross"], x_in, (ck, cv))
    ffn_in = rms_norm(h, p_l["ln2"], eps=cfg.norm_eps)
    return h + ffn(cfg, p_l["ffn"], ffn_in)


def lm_forward(cfg: ArchConfig, params, tokens: torch.Tensor, frames: torch.Tensor):
    """Teacher-forced decode over the full token sequence. tokens: (B, S);
    frames: (B, T, d). Returns (logits (B, S, V), aux 0)."""
    cd = dtype_of(cfg.compute_dtype)
    enc_out = encode(cfg, params, frames)
    cross_kv = _decoder_cross_kv(cfg, params, enc_out)
    h = embed(params["embed"], tokens, compute_dtype=cd)
    for p_l, (ck, cv) in zip(params["decoder"], cross_kv):
        h = _remat(cfg, lambda x, k_, v_, p_l=p_l: _decoder_layer(cfg, p_l, x, k_, v_))(h, ck, cv)
    h = rms_norm(h, params["final_norm"], eps=cfg.norm_eps)
    logits = unembed(params["embed"], h, tie=cfg.tie_embeddings)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def lm_loss(cfg: ArchConfig, params, tokens: torch.Tensor, labels: torch.Tensor,
            frames: torch.Tensor, *, z_loss: float = 1e-4, **_):
    """Mean cross-entropy with the z-loss: (loss, {"ce_loss", "moe_aux"})."""
    logits, _ = lm_forward(cfg, params, tokens, frames)
    loss = softmax_cross_entropy(logits, labels, z_loss=z_loss)
    return loss, {"ce_loss": loss, "moe_aux": torch.zeros_like(loss)}


def init_states(cfg: ArchConfig, batch: int, max_len: int, *, device=None):
    """Zeroed decoder state on `device` (None: the current CUDA device):
    per layer a (batch, max_len, KV, hd) self-attention cache pair and a
    (batch, T, KV, hd) cross K/V pair, every tensor its own."""
    cd = dtype_of(cfg.compute_dtype)
    KV, hd, T = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.encoder_context
    device = resolve_device(device)
    states = {"k": [], "v": [], "cross_k": [], "cross_v": []}
    for _ in range(cfg.num_layers):
        k, v = init_kv_cache(cfg, batch, max_len, window=0, dtype=cd, device=device)
        states["k"].append(k)
        states["v"].append(v)
        for name in ("cross_k", "cross_v"):
            states[name].append(torch.zeros((batch, T, KV, hd), dtype=cd, device=device))
    return states


def lm_prefill(cfg: ArchConfig, params, tokens: torch.Tensor, states, frames: torch.Tensor):
    """Encode, then the teacher-forced prefill of the decoder prompt.
    tokens: (B, S); frames: (B, T, d). The state is written in place, the
    cross K/V copied into it. Returns (last-position logits (B,V), state)."""
    cd = dtype_of(cfg.compute_dtype)
    enc_out = encode(cfg, params, frames)
    cross_kv = _decoder_cross_kv(cfg, params, enc_out)
    h = embed(params["embed"], tokens, compute_dtype=cd)
    for i, (p_l, (ck, cv)) in enumerate(zip(params["decoder"], cross_kv)):
        attn_in = rms_norm(h, p_l["ln1"], eps=cfg.norm_eps)
        attn_out, (states["k"][i], states["v"][i]) = prefill_attention(
            cfg, p_l["attn"], attn_in, (states["k"][i], states["v"][i]))
        h = h + attn_out
        x_in = rms_norm(h, p_l["ln_x"], eps=cfg.norm_eps)
        h = h + cross_attention(cfg, p_l["cross"], x_in, (ck, cv))
        ffn_in = rms_norm(h, p_l["ln2"], eps=cfg.norm_eps)
        h = h + ffn(cfg, p_l["ffn"], ffn_in)
        states["cross_k"][i].copy_(ck)
        states["cross_v"][i].copy_(cv)
    h = rms_norm(h[:, -1:], params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], h[:, 0], tie=cfg.tie_embeddings), states


def lm_decode_step(cfg: ArchConfig, params, states, tokens: torch.Tensor, pos):
    """One decode step: tokens (B, 1); pos a scalar or (B,). The caches are
    written in place. Returns (logits (B,V), state)."""
    cd = dtype_of(cfg.compute_dtype)
    pos = slot_positions(pos, tokens.shape[0], tokens.device)  # once for every layer
    h = embed(params["embed"], tokens, compute_dtype=cd)
    for i, p_l in enumerate(params["decoder"]):
        attn_in = rms_norm(h, p_l["ln1"], eps=cfg.norm_eps)
        attn_out, (states["k"][i], states["v"][i]) = decode_self_attention(
            cfg, p_l["attn"], attn_in, (states["k"][i], states["v"][i]), pos)
        h = h + attn_out
        x_in = rms_norm(h, p_l["ln_x"], eps=cfg.norm_eps)
        h = h + cross_attention(cfg, p_l["cross"], x_in,
                                (states["cross_k"][i], states["cross_v"][i]))
        ffn_in = rms_norm(h, p_l["ln2"], eps=cfg.norm_eps)
        h = h + ffn(cfg, p_l["ffn"], ffn_in)
    h = rms_norm(h, params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], h[:, 0], tie=cfg.tie_embeddings), states
