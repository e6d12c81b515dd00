"""Wrapper of the hand-written CUDA dense-cache decode-attention kernel
(`csrc/decode_attention.cu`, on the shared core `csrc/decode_core.cuh`).

Replaces the reference's Pallas TPU kernel
`repro/kernels/decode_attention.py::decode_attention`. On the H100 it is
bound by bytes: every valid K/V row is read once for only
4 * groups * head_dim FLOP. It runs the paged kernel's algorithm (a dense
cache is a pool of one page per slot): one launch per call, a thread-block
cluster of `decode_core.cluster_size` blocks per (slot, KV head) splitting
the positions <= pos among its blocks on the device and merging them
through distributed shared memory; bf16 rows are scored on the tensor
cores (`decode_core.variant`). Any cache depth S runs.

The wrapper checks device, dtype, shape, contiguity and the 16-byte load
layout (`decode_core.layout_error`), broadcasts a scalar `pos`, allocates
the output with `torch.empty`, launches on the current stream without
synchronising, and counts its launches in `launches` and, by variant, in
`variant_launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build, decode_core

#: Kernel launches made by this process (one per call of `decode_attention`).
launches = 0
#: The same launches by variant (`decode_core.variant`).
variant_launches = {kind: 0 for kind in decode_core.VARIANT_CODES}


@functools.cache
def _entry():
    fn = build.load().decode_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: (B, H, hd); k/v_cache: (B, S, KV, hd); pos: int32 scalar or (B,),
    each >= 0 (positions past S - 1 see the whole cache). Returns
    (B, H, hd), on CUDA."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("decode_attention: q must be (B, H, hd), caches (B, S, KV, hd)")
    B, H, hd = q.shape
    Bk, S, KV, hdk = k_cache.shape
    if v_cache.shape != k_cache.shape or Bk != B or hdk != hd:
        raise ValueError(
            f"decode_attention: shapes q{tuple(q.shape)} k{tuple(k_cache.shape)} "
            f"v{tuple(v_cache.shape)}"
        )
    if KV < 1 or H % KV:
        raise ValueError(f"decode_attention: {H} query heads not a multiple of {KV} kv heads")
    if S < 1:
        raise ValueError("decode_attention: empty cache")
    if not isinstance(pos, torch.Tensor):  # a Python int serves every slot
        pos = torch.full((B,), int(pos), dtype=torch.int32, device=q.device)
    if pos.numel() not in (1, B) or pos.dim() > 1:
        raise ValueError(f"decode_attention: pos must be a scalar or ({B},), "
                         f"got {tuple(pos.shape)}")
    pos = pos.reshape(-1).expand(B).contiguous()  # a scalar serves every slot
    decode_core.check_operands("decode_attention", q, k_cache, v_cache, pos=pos)
    scale = scale if scale is not None else 1.0 / (hd**0.5)
    cluster = decode_core.cluster_size(q, k_cache)
    kind = decode_core.variant(q, k_cache)
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, S, H, KV, hd, decode_core.DTYPE_CODES[q.dtype], float(scale), cluster,
        decode_core.VARIANT_CODES[kind], torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, f"decode_attention ({kind})")
    build.count_launch(__name__, kind)
    return out
