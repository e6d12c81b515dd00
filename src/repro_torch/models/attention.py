"""Attention layers: GQA/MQA self-attention prefill that fills a dense KV
cache, one-token decode over that dense cache, and the paged KV-cache decode
path. Port of the serving half of `repro/models/attention.py`.

Weights keep the reference's einsum shapes, heads as their own dimension:

    wq: (d, H, hd)    wk, wv: (d, KV, hd)    wo: (H, hd, d)

Caches and pools are updated IN PLACE (the reference returns functionally
updated arrays); every function still returns them, so call sites read like
the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops
from .common import ParamInit, apply_rope, resolve_device


def init_attention(pi: ParamInit, cfg: ArchConfig):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "wq": pi.normal((d, H, hd), fan_in=d),
        "wk": pi.normal((d, KV, hd), fan_in=d),
        "wv": pi.normal((d, KV, hd), fan_in=d),
        "wo": pi.normal((H, hd, d), fan_in=H * hd),
    }


def _project_qkv(cfg: ArchConfig, p, x: torch.Tensor, positions: Optional[torch.Tensor]):
    """x: (B,S,d) -> q (B,S,H,hd), k/v (B,S,KV,hd), RoPE'd, contiguous."""
    B, S, d = x.shape
    cd = x.dtype
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"].to(cd).reshape(d, H * hd)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(cd).reshape(d, KV * hd)).reshape(B, S, KV, hd)
    v = (x @ p["wv"].to(cd).reshape(d, KV * hd)).reshape(B, S, KV, hd)
    if positions is not None:
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _out_proj(p, out: torch.Tensor) -> torch.Tensor:
    """(..., H, hd) -> (..., d) through wo (H, hd, d)."""
    H, hd, d = p["wo"].shape
    return out.reshape(*out.shape[:-2], H * hd) @ p["wo"].to(out.dtype).reshape(H * hd, d)


def prefill_attention(
    cfg: ArchConfig, p, x: torch.Tensor, cache: Tuple[torch.Tensor, torch.Tensor], *,
    window: int = 0, prefix_len: int = 0,
):
    """Prefill: full-sequence causal attention that also fills the KV cache.

    cache: (k_cache, v_cache) each (B, S_buf, KV, hd); for windowed layers
    S_buf == window (ring buffer), else S_buf >= S. Written in place.
    Returns (out (B,S,d), cache).
    """
    B, S, d = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = ops.attention(q, k, v, causal=True, window=window, prefix_len=prefix_len)
    k_cache, v_cache = cache
    S_buf = k_cache.shape[1]
    if window and S_buf == window:
        # ring buffer: keep the last `window` entries at slots pos % window
        take = min(window, S)
        slots = torch.arange(S - take, S, device=x.device) % window
        k_cache[:, slots] = k[:, S - take :].to(k_cache.dtype)
        v_cache[:, slots] = v[:, S - take :].to(v_cache.dtype)
    else:
        k_cache[:, :S] = k.to(k_cache.dtype)
        v_cache[:, :S] = v.to(v_cache.dtype)
    return _out_proj(p, out), (k_cache, v_cache)


def slot_positions(pos, batch: int, device) -> torch.Tensor:
    """A decode position as (batch,) int32 on `device`: a per-slot (batch,)
    tensor as is, a scalar (the serial engine's shared position) broadcast."""
    return torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1).expand(batch)


def decode_self_attention(
    cfg: ArchConfig, p, x: torch.Tensor, cache: Tuple[torch.Tensor, torch.Tensor], pos, *,
    window: int = 0,
):
    """One-token decode step over a dense per-slot KV cache, batched over
    slots. x: (B, 1, d); pos: each slot's current position, (B,) or a scalar
    shared by the whole batch (the serial engine). The reference vmaps a B=1
    step over slots; here the batch dimension is written out, so RoPE, the
    ring slot ``pos % window``, the ``eff_pos`` clamp and the cache write are
    per slot. The write lands at the slot index clamped into the buffer, as
    the reference's `dynamic_update_slice` clamps its start (only inactive
    slots, whose outputs are discarded, run past the buffer). The cache is
    written in place. Returns (out (B,1,d), cache)."""
    B = x.shape[0]
    pos = slot_positions(pos, B, x.device)
    q, k, v = _project_qkv(cfg, p, x, pos[:, None])  # (B,1,H,hd) / (B,1,KV,hd)
    k_cache, v_cache = cache
    S_buf = k_cache.shape[1]
    slot = torch.remainder(pos, window) if window and S_buf == window else pos
    slot = torch.clamp(slot, 0, S_buf - 1).long()
    rows = torch.arange(B, device=x.device)
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    # ring buffers are fully valid once warm: validity is slot <= eff_pos
    eff_pos = torch.clamp(pos, max=S_buf - 1)
    out = ops.decode_attention(q[:, 0], k_cache, v_cache, eff_pos, window=window)
    return _out_proj(p, out)[:, None, :], (k_cache, v_cache)


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int, *, window: int = 0,
                  dtype=torch.bfloat16, device=None):
    """One layer's (k, v) dense cache (batch, S_buf, KV, hd), zeroed on
    `device` (None: the current CUDA device)."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    S_buf = min(window, max_len) if window else max_len
    shape = (batch, S_buf, KV, hd)
    device = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# paged KV cache: block-pool layout + paged decode attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static geometry of a paged KV cache (see the reference's
    `PagedLayout`).

    Full-attention layers share one growing page table (``n_pages_seq``
    logical pages per slot) over ``num_pages`` physical pages; page 0 is the
    null page, never allocated: it absorbs inactive slots' writes and pads
    unallocated table entries. Sliding-window layers keep ring buffers,
    paged: slot s owns ring pages ``[s * w_pages, (s + 1) * w_pages)`` for
    its lifetime. When ``max_len`` fits under the window the ring never
    wraps and those layers page like full layers (``ring`` False). The
    reference's ``shared`` (prefix-cache) layout is not ported yet.
    """

    max_slots: int
    page_size: int
    cache_len: int  # max_len rounded up to a page multiple
    n_pages_seq: int  # full-layer page-table width (logical pages per slot)
    num_pages: int  # full-pool physical pages, null page included
    window: int
    ring: bool
    w_pages: int  # ring pages per slot (0 when not ring)

    @property
    def ring_pages_total(self) -> int:
        return self.max_slots * self.w_pages

    def ring_table(self, device=None) -> torch.Tensor:
        """(max_slots, w_pages) int32 identity page table of the rings."""
        base = torch.arange(self.max_slots, dtype=torch.int32, device=device)[:, None] * self.w_pages
        return base + torch.arange(self.w_pages, dtype=torch.int32, device=device)[None, :]

    def pages_for(self, n_positions: int) -> int:
        """Full-table pages needed to hold `n_positions` cache positions."""
        return -(-min(n_positions, self.cache_len) // self.page_size)


def paged_layout(
    cfg: ArchConfig,
    *,
    max_slots: int,
    max_len: int,
    page_size: int,
    num_pages: Optional[int] = None,
) -> PagedLayout:
    cache_len = -(-max_len // page_size) * page_size
    n_pages_seq = cache_len // page_size
    w = cfg.sliding_window or 0
    ring = bool(w) and w <= cache_len
    if ring and w % page_size != 0:
        raise ValueError(
            f"page_size {page_size} must divide sliding_window {w} "
            f"(ring buffers are paged at page granularity)"
        )
    if num_pages is None:
        # every slot can hold a full-length sequence, plus the null page
        num_pages = max_slots * n_pages_seq + 1
    return PagedLayout(
        max_slots=max_slots,
        page_size=page_size,
        cache_len=cache_len,
        n_pages_seq=n_pages_seq,
        num_pages=int(num_pages),
        window=w,
        ring=ring,
        w_pages=(w // page_size) if ring else 0,
    )


def init_paged_kv_pool(cfg: ArchConfig, n_pages: int, page_size: int, *,
                       dtype=torch.bfloat16, device=None):
    """One layer's (k, v) block-pool tensors: (n_pages, page, KV, hd), zeroed
    on `device` (None: the current CUDA device)."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (n_pages, page_size, KV, hd)
    device = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def paged_decode_self_attention(
    cfg: ArchConfig,
    p,
    x: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    table: torch.Tensor,
    pos: torch.Tensor,
    active: torch.Tensor,
    *,
    page_size: int,
    window: int = 0,
    ring: bool = True,
):
    """One-token decode step against a paged KV pool, batched over slots.

    x: (B, 1, d); pool_k/v: (P, page, KV, hd), this layer's pool, written in
    place; table: (B, n_pages) int32; pos: (B,) int32 per-slot positions;
    active: (B,) bool. Inactive slots write the null page (dynamic-table
    layers) or position 0 of their own ring (ring layers), so they never
    touch a live slot's cache. `window` > 0 with ``ring`` is ring semantics:
    writes wrap at ``pos % window`` and every ring entry is valid once warm.
    Returns (out (B,1,d), (pool_k, pool_v)).
    """
    positions = pos[:, None]  # RoPE at each slot's own position
    q, k, v = _project_qkv(cfg, p, x, positions)  # (B,1,H,hd) / (B,1,KV,hd)

    is_ring = bool(window) and ring
    cache_pos = torch.remainder(pos, window) if is_ring else pos
    cache_pos = torch.where(active, cache_pos, torch.zeros_like(cache_pos))
    page_idx = torch.div(cache_pos, page_size, rounding_mode="floor")
    offset = torch.remainder(cache_pos, page_size)
    phys = torch.gather(table, 1, page_idx[:, None].long())[:, 0]
    if not is_ring:
        # dynamic-table layers: inactive slots write the null page (their
        # table rows may name pages since freed and reallocated)
        phys = torch.where(active, phys, torch.zeros_like(phys))
    pool_k[phys.long(), offset.long()] = k[:, 0].to(pool_k.dtype)
    pool_v[phys.long(), offset.long()] = v[:, 0].to(pool_v.dtype)

    S_eff = table.shape[1] * page_size
    eff_pos = torch.clamp(pos, max=S_eff - 1)
    out = ops.paged_decode_attention(
        q[:, 0], pool_k, pool_v, table, eff_pos, window=0 if is_ring else window,
    )
    return _out_proj(p, out)[:, None, :], (pool_k, pool_v)
