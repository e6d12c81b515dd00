"""Launch rules of the decode-attention core (`csrc/decode_core.cuh`) that
the dense and the paged decode kernels share, as pure functions the CPU
tests reach, and the operand checks of both wrappers.

* `cluster_size`: the blocks of the thread-block cluster that walks one
  unit, a (slot, KV head, head group): the smallest power of two up to
  `MAX_CLUSTER` with which the clusters fill one wave of the card's SMs, and
  1 when the units alone fill it. Each block of a cluster takes an even
  share of its slot's valid positions, read on the device.
* `head_groups` / `block_group`: a block holds at most `MAX_GROUP` query
  heads in registers; a KV head with more (granite-20b: 48 over 1) splits
  its heads into `head_groups` groups of `block_group` (the last may hold
  fewer), a grid axis, each group's cluster re-reading the KV head's rows.
  At 8 heads or fewer there is one group and the launch is unchanged.
* `layout_error`: the shapes and pointers the kernels take: any head_dim
  up to 256 and 16-byte aligned K and V. Rows that are a whole number of
  16-byte loads are copied by cp.async 16 bytes a lane; other rows (bf16 at
  head_dim 36, fp32 at 18: most rows start unaligned) by element loads, on
  the ``simt`` walk. The wrappers raise on any other layout.
* `variant`: how a block walks its positions. ``mma``: bf16 at head_dim 16,
  32, 64, 128 or 256, scores and P V on the tensor cores (`mma.sync`
  m16n8k16, fp32 accumulation, P rounded to bf16 as the flash kernel's wgmma
  variant does), eight positions a warp step; ``simt``: everything else
  (fp32, whose 1e-5 parity bf16 products would break, and other head dims,
  rows that are not whole 16-byte loads among them), exact fp32 FMA. Both
  wrappers count their launches by variant.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

WARPS = 8  # warps a block
MAX_HEAD_DIM = 256
MAX_GROUP = 8  # query heads a block holds in registers
#: The largest cluster `cluster_size` picks: 8 is the portable limit.
MAX_CLUSTER = 8
LOAD_BYTES = 16  # a lane's load
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VARIANT_CODES = {"simt": 0, "mma": 1}
MMA_HEAD_DIMS = (16, 32, 64, 128, 256)  # whole k16 steps, unrolled at compile time


def variant(q: torch.Tensor, k: torch.Tensor) -> str:
    """The walk `decode_attention` / `paged_decode_attention` launch for q
    against K rows k (see the module note): a rule on dtype and head_dim
    (every ``mma`` head dim is a whole number of 16-byte bf16 loads)."""
    return "mma" if q.dtype == torch.bfloat16 and k.shape[-1] in MMA_HEAD_DIMS else "simt"


def head_groups(groups: int) -> int:
    """Head groups a KV head with `groups` query heads splits into."""
    return -(-groups // MAX_GROUP)


def block_group(groups: int) -> int:
    """Query heads a block holds for `groups` query heads per KV head
    (`csrc/decode_core.cuh::block_group`)."""
    return -(-groups // head_groups(groups))


def cluster_size(q: torch.Tensor, k: torch.Tensor) -> int:
    """Blocks a cluster for q (B, H, hd) against K rows (..., KV, hd) on q's
    card (see the module note): B * KV * head groups clusters against
    `build.sm_count(q.device)` multiprocessors."""
    KV = k.shape[-2]
    units = q.shape[0] * KV * head_groups(q.shape[1] // KV)
    sms = build.sm_count(q.device)
    c = 1
    while c < MAX_CLUSTER and units * c < sms:
        c *= 2
    return c


def layout_error(num_heads: int, k: torch.Tensor, v: torch.Tensor) -> Optional[str]:
    """Why the kernel cannot take K and V rows of this layout, or None.
    k, v: (..., KV, hd) with hd contiguous; `num_heads` query heads."""
    hd = k.shape[-1]
    if not 1 <= hd <= MAX_HEAD_DIM:
        return f"head_dim {hd} outside 1..{MAX_HEAD_DIM}"
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % LOAD_BYTES:
            return f"{name} is not {LOAD_BYTES}-byte aligned"
    return None


def smem_bytes(dtype: torch.dtype, groups: int, head_dim: int, kind: str) -> int:
    """Dynamic shared memory a block of variant `kind` asks for at these
    operands, from the built library (`decode_attention.cu::decode_smem_bytes`)."""
    fn = build.load().decode_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(DTYPE_CODES[dtype], groups, head_dim, VARIANT_CODES[kind])


def check_operands(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   **int32: torch.Tensor) -> None:
    """Raise ValueError unless q, k, v (one float dtype) and the int32
    tensors are contiguous on q's CUDA device and k, v pass `layout_error`."""
    for name, t in (("q", q), ("k", k), ("v", v), *int32.items()):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{what}: {name} must be on q's CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} dtype {t.dtype}; need fp32/bf16 for all")
    for name, t in int32.items():
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: {name} must be int32, got {t.dtype}")
    err = layout_error(q.shape[1], k, v)
    if err:
        raise ValueError(f"{what}: {err}")
