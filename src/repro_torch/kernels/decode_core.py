"""Launch rules of the decode-attention core (`csrc/decode_core.cuh`) that
the dense and the paged decode kernels share, as pure functions the CPU
tests reach, and the operand checks of both wrappers.

* `cluster_size`: the blocks of the thread-block cluster that walks one
  unit, a (slot, KV head, head group): the largest power of two up to
  `MAX_CLUSTER` with which the clusters still fit one wave of one block an
  SM, and 1 when the units alone exceed it. Each block of a cluster takes
  an even share of its slot's valid positions, read on the device. (The
  smallest power of two that filled the wave put 256 blocks on 132 SMs at
  64 units, the dense family's and the MoE family's ticks; clusters of 2
  measured faster there on both walks, 11-30 % on ``mma``, and granite-20b's
  48 units 5-11 % slower, PERF.md section 6.)
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
  32, 64, 80, 112, 128, 160 or 256 (`MMA_HEAD_DIMS`), scores and P V on the
  tensor cores (`mma.sync` m16n8k16, fp32 accumulation, P rounded to bf16 as
  the flash kernel's wgmma variant does), eight positions a warp step, each
  head dim its own instantiation at the row's width; but one query head a
  KV head at the padded dims 80, 112 and 160 stays on ``simt``, where one
  row of the 16-row tiles is real and zamba2-7b's tick (32 over 32, hd 112)
  measured 0.0228 ms on ``mma`` against 0.0218 on ``simt`` (PERF.md,
  section 6); ``simt``: everything else (fp32, whose 1e-5 parity bf16
  products would break, and other head dims, rows that are not whole
  16-byte loads among them), exact fp32 FMA. Both wrappers count their
  launches by variant.
* `mma_ring_slot`: where the ``mma`` walk keeps a K / V row's 16-byte chunk
  in its shared-memory tiles (`csrc/decode_core.cuh::MmaGeo`).
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
#: Head dims of the tensor-core walk: whole k16 steps (and n8 tiles), each
#: unrolled at compile time; 80, 112 and 160 are the configs' dims between
#: the powers of two (train_100m; zamba2-7b and kimi-k2; stablelm-12b).
MMA_HEAD_DIMS = (16, 32, 64, 80, 112, 128, 160, 256)
#: Of those, the dims whose ring rows are padded: at one query head a KV
#: head they stay on the SIMT walk (see the module note).
MMA_PADDED_DIMS = (80, 112, 160)
#: Positions (rows) of one K or V tile of the ``mma`` walk.
MMA_TILE_ROWS = 8


def variant(q: torch.Tensor, k: torch.Tensor) -> str:
    """The walk `decode_attention` / `paged_decode_attention` launch for q
    (B, H, hd) against K rows k (..., KV, hd) (see the module note): a rule
    on dtype, head_dim and query heads a KV head (every ``mma`` head dim is
    a whole number of 16-byte bf16 loads)."""
    hd, groups = k.shape[-1], q.shape[1] // k.shape[-2]
    if q.dtype != torch.bfloat16 or hd not in MMA_HEAD_DIMS:
        return "simt"
    return "simt" if groups == 1 and hd in MMA_PADDED_DIMS else "mma"


def mma_row_chunks(head_dim: int) -> int:
    """16-byte chunks a row of the ``mma`` walk's tiles spans in shared
    memory: the bf16 row's hd / 8 chunks, rounded up to whole groups of 8
    (128 bytes) once there are 8 or more (hd 80 and 112: 16, hd 160: 24)."""
    n = head_dim // 8
    return n if n <= 8 else -(-n // 8) * 8


def mma_ring_slot(head_dim: int, row: int, chunk: int) -> int:
    """The 16-byte slot of a tile at which the ``mma`` walk keeps `chunk`
    of the tile's `row` (`csrc/decode_core.cuh::MmaGeo`): chunk ^ (row %
    8) (the mask shrinks to the chunk count under 8) within the row's
    `mma_row_chunks`, so that ldmatrix reads a chunk of eight rows from
    eight distinct bank groups."""
    n = head_dim // 8
    return row * mma_row_chunks(head_dim) + (chunk ^ (row & (min(n, 8) - 1)))


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
    while c < MAX_CLUSTER and units * c * 2 <= sms:
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
