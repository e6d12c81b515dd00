"""Decoder-only LM for serving: dense transformers with sliding-window /
global interleaving (gemma3). Port of the serving half of
`repro/models/transformer.py`.

The reference stacks layers for `jax.lax.scan`, grouped in repeating units
(gemma3: 5 local layers + 1 global) plus a tail. PyTorch runs eagerly, so
the port keeps one parameter dict and one cache per layer in a plain list,
in layer order: unit u, layer j of the reference is layer ``unit_len * u +
j``; tail layer t is layer ``unit_len * n_units + t`` (`models/bridge.py`
maps one onto the other). Caches and pools are written in place.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.configs import ArchConfig
from .attention import (
    PagedLayout,
    decode_self_attention,
    init_attention,
    init_kv_cache,
    init_paged_kv_pool,
    paged_decode_self_attention,
    prefill_attention,
    slot_positions,
)
from .common import (
    ParamInit,
    dtype_of,
    embed,
    init_embedding,
    resolve_device,
    rms_norm,
    unembed,
)
from .ffn import ffn, init_ffn

# ---------------------------------------------------------------------------
# layer structure
# ---------------------------------------------------------------------------


def layer_windows(cfg: ArchConfig) -> List[int]:
    """Static per-layer window sizes. 0 = global (full) attention."""
    if not cfg.sliding_window:
        return [0] * cfg.num_layers
    g = cfg.global_interval
    return [0 if (i + 1) % g == 0 else cfg.sliding_window for i in range(cfg.num_layers)]


def has_units(cfg: ArchConfig) -> bool:
    """Sliding-window archs group layers in repeating (local*, global) units."""
    return bool(cfg.sliding_window and cfg.global_interval)


def unit_structure(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(unit_len, n_units, n_tail) of the reference's scan grouping."""
    if not has_units(cfg):
        return cfg.num_layers, 1, 0
    g = cfg.global_interval
    return g, cfg.num_layers // g, cfg.num_layers % g


def serving_windows(cfg: ArchConfig) -> List[int]:
    """Window of each layer on the serving path: the reference's unit path
    windows local layers; its homogeneous stack serves every layer global."""
    return layer_windows(cfg) if has_units(cfg) else [0] * cfg.num_layers


def init_lm(cfg: ArchConfig, *, seed: int = 0, device=None, dtype=None):
    """Seeded parameters on `device` (None: the current CUDA device, raising
    where there is none; pass ``device="cpu"`` for the CPU). Matrices are
    stored in `dtype`
    (default: the config's param dtype; the compute dtype stores them once
    at full width, which changes no number since every use casts to it);
    norm weights stay fp32, as `rms_norm` reads them."""
    if cfg.is_moe:
        raise NotImplementedError("MoE layers are not ported yet")
    pi = ParamInit(seed, resolve_device(device), dtype or dtype_of(cfg.param_dtype))
    d = cfg.d_model
    params = {
        "embed": init_embedding(pi, cfg.vocab_size, d, tie=cfg.tie_embeddings),
        "final_norm": pi.zeros((d,), dtype=torch.float32),
        "layers": [],
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln1": pi.zeros((d,), dtype=torch.float32),
            "ln2": pi.zeros((d,), dtype=torch.float32),
            "attn": init_attention(pi, cfg),
            "ffn": init_ffn(pi, cfg),
        })
    return params


# ---------------------------------------------------------------------------
# dense KV caches + prefill
# ---------------------------------------------------------------------------


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *, device=None):
    """Per-layer (k, v) caches: ring buffers of `window` entries on local
    layers, `max_len` deep on global ones, on `device` (None: the current
    CUDA device)."""
    cd = dtype_of(cfg.compute_dtype)
    return [
        init_kv_cache(cfg, batch, max_len, window=w, dtype=cd, device=device)
        for w in serving_windows(cfg)
    ]


def _prefill_layer(cfg, p_l, h, cache_kv, *, window, prefix_len=0):
    attn_in = rms_norm(h, p_l["ln1"], eps=cfg.norm_eps)
    attn_out, new_cache = prefill_attention(
        cfg, p_l["attn"], attn_in, cache_kv, window=window, prefix_len=prefix_len
    )
    h = h + attn_out
    ffn_in = rms_norm(h, p_l["ln2"], eps=cfg.norm_eps)
    return h + ffn(cfg, p_l["ffn"], ffn_in), new_cache


def _decode_layer(cfg, p_l, h, cache_kv, pos, *, window):
    attn_in = rms_norm(h, p_l["ln1"], eps=cfg.norm_eps)
    attn_out, new_cache = decode_self_attention(cfg, p_l["attn"], attn_in, cache_kv, pos,
                                                window=window)
    h = h + attn_out
    ffn_in = rms_norm(h, p_l["ln2"], eps=cfg.norm_eps)
    return h + ffn(cfg, p_l["ffn"], ffn_in), new_cache


def backbone_prefill(cfg: ArchConfig, params, h, caches, *, prefix_len: int = 0):
    """h: (B,S,d) embedded inputs. Returns (h, caches)."""
    for i, (p_l, w) in enumerate(zip(params["layers"], serving_windows(cfg))):
        h, caches[i] = _prefill_layer(cfg, p_l, h, caches[i], window=w, prefix_len=prefix_len)
    return h, caches


def lm_prefill(cfg: ArchConfig, params, tokens: torch.Tensor, caches, *, prefix_len: int = 0):
    """tokens: (B,S). Returns (last-position logits (B,V), caches)."""
    cd = dtype_of(cfg.compute_dtype)
    h = embed(params["embed"], tokens, compute_dtype=cd)
    h, caches = backbone_prefill(cfg, params, h, caches, prefix_len=prefix_len)
    h = rms_norm(h[:, -1:], params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], h[:, 0], tie=cfg.tie_embeddings), caches


def lm_decode_step(cfg: ArchConfig, params, caches, tokens: torch.Tensor, pos):
    """One decode step over dense per-layer caches. tokens: (B, 1); pos: a
    scalar shared by the batch (the serial engine) or (B,) per-slot
    positions (the slot decoder). Returns (logits (B,V), caches), the caches
    updated in place."""
    cd = dtype_of(cfg.compute_dtype)
    pos = slot_positions(pos, tokens.shape[0], tokens.device)  # once for every layer
    h = embed(params["embed"], tokens, compute_dtype=cd)  # (B,1,d)
    for i, (p_l, w) in enumerate(zip(params["layers"], serving_windows(cfg))):
        h, caches[i] = _decode_layer(cfg, p_l, h, caches[i], pos, window=w)
    h = rms_norm(h, params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], h[:, 0], tie=cfg.tie_embeddings), caches


# ---------------------------------------------------------------------------
# paged KV-cache serving: block-pool caches + page-table decode
# ---------------------------------------------------------------------------


def init_paged_caches(cfg: ArchConfig, layout: PagedLayout, *, device=None):
    """Per-layer (k, v) block pools shared by every slot (the page table is
    the slot axis), on `device` (None: the current CUDA device). Global
    layers pool `layout.num_pages` pages addressed by the dynamic full table;
    local layers pool every slot's fixed ring pages, or page like global
    layers when the layout has no ring."""
    cd = dtype_of(cfg.compute_dtype)
    n_local = layout.ring_pages_total if layout.ring else layout.num_pages
    return [
        init_paged_kv_pool(cfg, n_local if w else layout.num_pages, layout.page_size,
                           dtype=cd, device=device)
        for w in serving_windows(cfg)
    ]


def _split_pages(cache: torch.Tensor, page_size: int) -> torch.Tensor:
    """(B=1, S, KV, hd) dense cache -> (S // page, page, KV, hd)."""
    c = cache.squeeze(0)
    return c.reshape(c.shape[0] // page_size, page_size, *c.shape[1:])


def commit_prefill_paged(cfg: ArchConfig, layout: PagedLayout, pools, dense_caches,
                         full_row: torch.Tensor, ring_row: torch.Tensor):
    """Scatter one slot's B=1 dense prefill caches into its pool pages, in
    place. full_row: (n_pages_seq,) physical pages, 0-padded past the
    allocation (padded writes land on the null page); ring_row: (w_pages,)
    the slot's own ring pages (unused when the layout has no ring)."""
    p = layout.page_size
    full = full_row.long()
    local = ring_row.long() if layout.ring else full
    for (pk, pv), (dk, dv), w in zip(pools, dense_caches, serving_windows(cfg)):
        row = local if w else full
        pk[row] = _split_pages(dk, p)
        pv[row] = _split_pages(dv, p)
    return pools


def _paged_decode_layer(cfg, layout, p_l, h, pool_kv, table, pos, active, *, window, ring=True):
    attn_in = rms_norm(h, p_l["ln1"], eps=cfg.norm_eps)
    attn_out, new_kv = paged_decode_self_attention(
        cfg, p_l["attn"], attn_in, pool_kv[0], pool_kv[1], table, pos, active,
        page_size=layout.page_size, window=window, ring=ring,
    )
    h = h + attn_out
    ffn_in = rms_norm(h, p_l["ln2"], eps=cfg.norm_eps)
    return h + ffn(cfg, p_l["ffn"], ffn_in), new_kv


def lm_paged_decode_step(cfg: ArchConfig, layout: PagedLayout, params, pools,
                         full_table: torch.Tensor, tokens: torch.Tensor, pos: torch.Tensor,
                         active: torch.Tensor):
    """One batched decode tick over paged caches.

    tokens: (B,) last tokens; pos: (B,) int32 per-slot positions; active:
    (B,) bool (inactive slots compute garbage that never escapes: their K/V
    writes are null-routed and callers mask their tokens). Returns
    (logits (B,V), pools), the pools updated in place.
    """
    cd = dtype_of(cfg.compute_dtype)
    h = embed(params["embed"], tokens[:, None], compute_dtype=cd)  # (B,1,d)
    local_table = layout.ring_table(device=full_table.device) if layout.ring else full_table
    # off the ring, local layers page through the full table with no window
    local_window = layout.window if layout.ring else 0
    for i, (p_l, w) in enumerate(zip(params["layers"], serving_windows(cfg))):
        if w:
            h, pools[i] = _paged_decode_layer(
                cfg, layout, p_l, h, pools[i], local_table, pos, active,
                window=local_window, ring=layout.ring,
            )
        else:
            h, pools[i] = _paged_decode_layer(
                cfg, layout, p_l, h, pools[i], full_table, pos, active, window=0,
            )
    h = rms_norm(h, params["final_norm"], eps=cfg.norm_eps)
    return unembed(params["embed"], h[:, 0], tie=cfg.tie_embeddings), pools
