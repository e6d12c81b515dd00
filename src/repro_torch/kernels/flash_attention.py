"""Wrapper of the hand-written CUDA flash-attention kernel
(`csrc/flash_attention.cu`).

Replaces the reference's Pallas TPU kernel
`repro/kernels/flash_attention.py::flash_attention`. The source holds two
variants, and `variant` picks one by an explicit rule (nothing is caught and
retried):

* ``wgmma``: bf16, head_dim 64 / 128 / 256, query heads per KV head dividing
  64, q, k, v 16-byte aligned: both products on the tensor cores, K/V tiles
  delivered by TMA; the query heads that share a KV head share each K/V
  tile. Every gemma3 prefill at full width takes it. `consumer_warpgroups`
  picks one or two consumer warpgroups a block by the grid's size.
* ``simt``: everything else (fp32, whose 2e-5 parity TF32 would break; head
  dims 16 and 32 of the REDUCED configs, 112 of zamba2-7b, 160 of
  stablelm-12b): scalar fp32 FMA, 32 query rows a block.

Both mask ragged Sq / Skv themselves, so any prompt length runs without
padding (the Pallas wrapper needs block multiples), and visit only the key
tiles a block's rows can attend to. See the source for the block layouts.

The wrapper checks device, dtype, shape and contiguity, allocates the output
with `torch.empty`, launches on the current stream without synchronising,
and counts its launches in `launches` and, by variant, in
`variant_launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

#: head dims of the repo's configs: 16 and 32 (REDUCED), 112 (zamba2-7b, kimi-k2),
#: 160 (stablelm-12b), 64, 128, 256
SUPPORTED_HEAD_DIMS = (16, 32, 64, 112, 128, 160, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANT_CODES = {"simt": 0, "wgmma": 1}
#: (position, query head) rows of one consumer warpgroup of the wgmma variant.
WGMMA_ROWS = 64

#: Kernel launches made by this process (one per call of `flash_attention`).
launches = 0
#: The same launches by variant.
variant_launches = {name: 0 for name in _VARIANT_CODES}


@functools.cache
def _entry():
    fn = build.load().flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float] + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel variant `flash_attention` launches for these operands (see
    the module note); a rule on dtype, head_dim, group size and alignment
    only."""
    hd, groups = q.shape[3], q.shape[2] // k.shape[2]
    if (q.dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS and WGMMA_ROWS % groups == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))):
        return "wgmma"
    return "simt"


def consumer_warpgroups(q: torch.Tensor, k: torch.Tensor) -> int:
    """Consumer warpgroups a block of the wgmma variant: one when the grid of
    one-warpgroup blocks fits in one wave of q's card's multiprocessors
    (a single prompt: the chain of key tiles of the last rows sets the time,
    and a warpgroup with an SM's tensor cores to itself walks it faster), two
    otherwise (one warpgroup's softmax overlaps the other's products)."""
    B, Sq, H, _ = q.shape
    KV = k.shape[2]
    positions = WGMMA_ROWS // (H // KV)  # query positions a warpgroup holds
    blocks = -(-Sq // positions) * KV * B
    return 1 if blocks <= build.sm_count(q.device) else 2


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
    kind = variant(q, k, v)
    consumers = consumer_warpgroups(q, k) if kind == "wgmma" else 0
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Skv, H, KV, hd, _DTYPE_CODES[q.dtype], float(scale),
        int(bool(causal)), int(window or 0), int(prefix_len), int(q_offset),
        _VARIANT_CODES[kind], consumers, torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, f"flash_attention ({kind})")
    build.count_launch(__name__, kind)
    return out
