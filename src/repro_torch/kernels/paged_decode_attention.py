"""Wrapper of the hand-written CUDA paged decode-attention kernel
(`csrc/paged_decode_attention.cu`).

Replaces the reference's Pallas TPU kernel
`repro/kernels/paged_decode_attention.py::paged_decode_attention`. On the
H100 it is bound by bytes: every valid K/V row is read once for only
4 * groups * head_dim FLOP. The kernel reads its slot's page-table entries
itself (the Pallas scalar prefetch), walks only the valid positions -- never
the null-page padding past `pos` -- and shares each loaded row across the
query heads of a KV head. One block per (slot, KV head): 8 blocks on the
serving path, far from filling 132 SMs; split-K with a combine pass is the
planned fix.

The wrapper checks device, dtype, shape and contiguity, allocates the output
with `torch.empty`, launches on the current stream without synchronising,
and counts its launches in `launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches made by this process (one per call of `paged_decode_attention`).
launches = 0


@functools.cache
def _entry():
    fn = build.load().paged_decode_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, H, hd); k/v_pool: (P, page, KV, hd); page_table: (B, n_pages)
    int32; pos: (B,) int32, each >= 0. Returns (B, H, hd), on CUDA."""
    global launches
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError("paged_decode_attention: q must be (B, H, hd), pools (P, page, KV, hd)")
    B, H, hd = q.shape
    P, page, KV, hdk = k_pool.shape
    if v_pool.shape != k_pool.shape or hdk != hd:
        raise ValueError(
            f"paged_decode_attention: shapes q{tuple(q.shape)} k{tuple(k_pool.shape)} "
            f"v{tuple(v_pool.shape)}"
        )
    if KV < 1 or H % KV:
        raise ValueError(f"paged_decode_attention: {H} query heads not a multiple of {KV} kv heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"paged_decode_attention: head_dim {hd} > {MAX_HEAD_DIM}")
    if page_table.dim() != 2 or page_table.shape[0] != B or page_table.shape[1] < 1:
        raise ValueError(f"paged_decode_attention: page_table {tuple(page_table.shape)} for B={B}")
    if pos.shape != (B,):
        raise ValueError(f"paged_decode_attention: pos {tuple(pos.shape)}, need ({B},)")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("pos", pos)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} must be on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError(f"paged_decode_attention: {name} dtype {t.dtype}; need fp32/bf16 for all")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_decode_attention: page_table and pos must be int32")
    scale = scale if scale is not None else 1.0 / (hd**0.5)
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, H, KV, hd, page, page_table.shape[1],
        _DTYPE_CODES[q.dtype], float(scale), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "paged_decode_attention")
    launches += 1
    return out
