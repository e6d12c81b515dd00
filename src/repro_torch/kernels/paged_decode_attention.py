"""Wrapper of the hand-written CUDA paged decode-attention kernel
(`csrc/paged_decode_attention.cu`, on the shared core `csrc/decode_core.cuh`).

Replaces the reference's Pallas TPU kernel
`repro/kernels/paged_decode_attention.py::paged_decode_attention`. On the
H100 it is bound by bytes: every valid K/V row is read once for only
4 * groups * head_dim FLOP. One launch per call: a thread-block cluster of
`decode_core.cluster_size` blocks per (slot, KV head) splits the slot's
valid positions -- never the null-page padding past `pos` -- among its
blocks on the device, each block reading its own page-table entries (the
Pallas scalar prefetch), and merges them through distributed shared memory.
Each loaded row serves the query heads of its KV head; bf16 rows are
scored on the tensor cores (`decode_core.variant`).

The wrapper checks device, dtype, shape, contiguity and the 16-byte load
layout (`decode_core.layout_error`), allocates the output with
`torch.empty`, launches on the current stream without synchronising, and
counts its launches in `launches` and, by variant, in `variant_launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build, decode_core

#: Kernel launches made by this process (one per call of `paged_decode_attention`).
launches = 0
#: The same launches by variant (`decode_core.variant`).
variant_launches = {kind: 0 for kind in decode_core.VARIANT_CODES}


@functools.cache
def _entry():
    fn = build.load().paged_decode_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
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
    if page_table.dim() != 2 or page_table.shape[0] != B or page_table.shape[1] < 1:
        raise ValueError(f"paged_decode_attention: page_table {tuple(page_table.shape)} for B={B}")
    if pos.shape != (B,):
        raise ValueError(f"paged_decode_attention: pos {tuple(pos.shape)}, need ({B},)")
    decode_core.check_operands("paged_decode_attention", q, k_pool, v_pool,
                               page_table=page_table, pos=pos)
    scale = scale if scale is not None else 1.0 / (hd**0.5)
    cluster = decode_core.cluster_size(q, k_pool)
    kind = decode_core.variant(q, k_pool)
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), B, H, KV, hd, page, page_table.shape[1],
        decode_core.DTYPE_CODES[q.dtype], float(scale), int(window or 0), cluster,
        decode_core.VARIANT_CODES[kind],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, f"paged_decode_attention ({kind})")
    launches += 1
    variant_launches[kind] += 1
    return out
