"""Wrapper of the hand-written CUDA flash-attention kernel
(`csrc/flash_attention.cu`).

Replaces the reference's Pallas TPU kernel
`repro/kernels/flash_attention.py::flash_attention`. On the H100, at the
serving path's prefill shapes (B=1, one prompt of 64-1024 tokens, 4 query
heads over 1 KV head, head_dim 256, bf16), a call is a few GFLOP: launch
overhead and the bytes of Q, K, V and O bound it, not the tensor cores. The
kernel stages each K/V tile once in shared memory for 32 query rows, visits
only the key tiles a block's rows can attend to, and masks ragged Sq / Skv
itself, so any prompt length runs without padding (the Pallas wrapper needs
block multiples). See the source for the block layout.

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

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches made by this process (one per call of `flash_attention`).
launches = 0


@functools.cache
def _entry():
    fn = build.load().flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    prefix_len: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd), on CUDA."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, S, heads, head_dim)")
    B, Sq, H, hd = q.shape
    Bk, Skv, KV, hdk = k.shape
    if v.shape != k.shape or Bk != B or hdk != hd:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads not a multiple of {KV} kv heads")
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {SUPPORTED_HEAD_DIMS}")
    if Sq < 1 or Skv < 1:
        raise ValueError("flash_attention: empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on q's CUDA device, got {t.device}")
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} dtype {t.dtype}; need one of fp32/bf16 for all")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    scale = scale if scale is not None else 1.0 / (hd**0.5)
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, KV, hd, _DTYPE_CODES[q.dtype], float(scale),
        int(bool(causal)), int(window or 0), int(prefix_len), int(q_offset),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention")
    launches += 1
    return out
