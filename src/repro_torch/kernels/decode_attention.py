"""Wrapper of the hand-written CUDA dense-cache decode-attention kernel
(`csrc/decode_attention.cu`).

Replaces the reference's Pallas TPU kernel
`repro/kernels/decode_attention.py::decode_attention`. On the H100 it is
bound by bytes: every valid K/V row is read once for only
4 * groups * head_dim FLOP. The kernel splits each slot's positions over
blocks of `split_len` (split-K), walks only positions <= pos, shares each
loaded row across the query heads of a KV head, and merges the splits'
partial softmax states in a second kernel on the same stream. Any cache
depth S runs: the ragged tail is masked in the kernel.

The wrapper checks device, dtype, shape and contiguity, broadcasts a scalar
`pos`, allocates the output and the split scratch with `torch.empty`,
launches on the current stream without synchronising, and counts its calls
in `launches` (one per call: the split and combine kernels together).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

MAX_HEAD_DIM = 256
CHUNK = 32  # positions per chunk of the kernel; split_len is a multiple
#: split blocks to aim for per call: a few per SM of a 132-SM card
TARGET_BLOCKS = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Calls that launched the kernel in this process.
launches = 0


@functools.cache
def _entry():
    fn = build.load().decode_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def split_len(B: int, KV: int, S: int) -> int:
    """Positions per split block: one chunk, or more where B * KV * chunks
    would launch far more blocks than `TARGET_BLOCKS`."""
    n_chunks = -(-S // CHUNK)
    return CHUNK * max(1, -(-(B * KV * n_chunks) // TARGET_BLOCKS))


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
    global launches
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
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {hd} > {MAX_HEAD_DIM}")
    if S < 1:
        raise ValueError("decode_attention: empty cache")
    if not isinstance(pos, torch.Tensor):  # a Python int serves every slot
        pos = torch.full((B,), int(pos), dtype=torch.int32, device=q.device)
    if pos.dtype != torch.int32 or pos.numel() not in (1, B) or pos.dim() > 1:
        raise ValueError(f"decode_attention: pos must be an int32 scalar or ({B},), "
                         f"got {pos.dtype} {tuple(pos.shape)}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache), ("pos", pos)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must be on q's CUDA device, got {t.device}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} dtype {t.dtype}; need fp32/bf16 for all")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    pos = pos.reshape(-1).expand(B).contiguous()  # a scalar serves every slot
    scale = scale if scale is not None else 1.0 / (hd**0.5)
    split = split_len(B, KV, S)
    n_splits = -(-S // split)
    G = H // KV
    part_acc = torch.empty((B, KV, n_splits, G, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, KV, n_splits, G, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        B, S, H, KV, hd, split, n_splits, _DTYPE_CODES[q.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "decode_attention")
    launches += 1
    return out
