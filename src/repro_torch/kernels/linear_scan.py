"""Wrapper of the hand-written CUDA chunkwise gated linear scan
(`csrc/linear_scan.cu`).

Replaces the reference's Pallas TPU kernel
`repro/kernels/linear_scan.py::gated_linear_scan`:

    S_t = a_t * S_{t-1} + k_t^T v_t ;  y_t = q_t @ S_t ;  a_t = exp(log_a_t)

with the decay in log space (cumulated in fp64 inside a chunk) and the
(dk, dv) state accumulated in fp32. Any S runs; `chunk` is the reference's
tiling knob and does not change the result
(`tests/test_kernels.py::test_chunk_size_invariance`), so the kernels accept
and ignore it.

Carried state: an optional fp32 `initial_state` replaces the zeros, as the
reference's ``ops.gated_linear_scan(..., initial_state=s0)`` computes (its
Pallas wrapper routes that case to the jnp oracle); the xlstm serving path
prefills from zero states and decodes one position at a time through it.

The mLSTM's normaliser: ``normaliser=True`` also returns what the reference's
second call with v = ones computes (`repro/models/ssm.py:97`), nrm
(B, H, S, 1) and its state n (B, H, dk, 1), from `initial_normaliser`, in the
same launch: the kernels treat it as one more column of v.

Three kernels, by an explicit rule (`variant`), counted in
`variant_launches`:

* ``step``: S <= `STEP_MAX_S` (a decode tick), any dtype: the state read
  and written once with 16-byte loads, positions walked in fp32.
* ``mma``: bf16 with S > `STEP_MAX_S`, dk <= `MMA_MAX_DK`, dk and dv
  multiples of 8 and 16-byte aligned rows (`mma_layout_error`): the chunk
  products on the tensor cores (mma.sync, bf16 hi + lo halves wherever an
  operand is not exact in bf16), the state in registers, the next chunk
  copied in by cp.async while one computes. A block owns `tile_columns`
  state columns, picked from the card's SM count.
* ``simt``: the rest (fp32, whose 2e-5 parity is kept by exact FMA): the
  chunk kernel on CUDA cores.

The wrapper checks device, dtype and shape, passes q, k, v and log_a by
their strides (head-split views of a projection need no copy), allocates
the outputs with `torch.empty`, launches on the current stream without
synchronising, and counts its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

MAX_DK = 1024
MMA_MAX_DK = 384  # the tensor-core kernel keeps dk x 64 fp32 of the state in registers
STEP_MAX_S = 16  # the step kernel's positions
MMA_TILES = (16, 32, 64)  # state columns a block of the tensor-core kernel owns
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
VARIANT_CODES = {"simt": 0, "mma": 1, "step": 2}

#: Kernel launches made by this process (one per call of `gated_linear_scan`).
launches = 0
#: The same launches by variant.
variant_launches = {kind: 0 for kind in VARIANT_CODES}


@functools.cache
def _entry():
    fn = build.load().gated_linear_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 15
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def mma_layout_error(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Optional[str]:
    """Why the tensor-core kernel's 16-byte row copies cannot take q, k, v
    (bf16 views of (B, H, S, d)), or None."""
    dk, dv = q.shape[-1], v.shape[-1]
    if dk > MMA_MAX_DK:
        return f"dk {dk} > {MMA_MAX_DK}"
    if dk % 8 or dv % 8:
        return f"dk {dk} or dv {dv} not a multiple of 8"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]):
            return f"{name} rows are not 16-byte strided"
        if t.data_ptr() % 16:
            return f"{name} is not 16-byte aligned"
    return None


def variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel `gated_linear_scan` launches for these operands (see the
    module note): a rule on S, dtype and layout."""
    if q.shape[2] <= STEP_MAX_S:
        return "step"
    if q.dtype == torch.bfloat16 and mma_layout_error(q, k, v) is None:
        return "mma"
    return "simt"


def tile_columns(B: int, H: int, columns: int, sms: int) -> int:
    """State columns a block of the tensor-core kernel owns for `columns`
    extended columns (dv, plus one for the normaliser) on `sms`
    multiprocessors: the narrowest tile whose grid still fits one wave (a
    narrower tile gives each block less of the state to carry through the
    chunks), and the widest when none does (the fewest blocks)."""
    for tile in MMA_TILES:
        if B * H * -(-columns // tile) <= sms:
            return tile
    return MMA_TILES[-1]


def mma_smem_bytes(tile: int, dk: int) -> int:
    """Dynamic shared memory a block of the tensor-core kernel asks for with
    `tile` state columns at this dk, from the built library."""
    fn = build.load().gated_linear_scan_mma_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(tile, dk)


def gated_linear_scan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    log_a: torch.Tensor,
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
    normaliser: bool = False,
    initial_normaliser: Optional[torch.Tensor] = None,
):
    """q, k: (B, H, S, dk); v: (B, H, S, dv) (fp32 or bf16, one dtype);
    log_a: (B, H, S) fp32; initial_state: None or contiguous fp32
    (B, H, dk, dv). Returns (y (B, H, S, dv) in q's dtype, final state
    (B, H, dk, dv) fp32), on CUDA. With ``normaliser=True`` (and an optional
    contiguous fp32 `initial_normaliser` (B, H, dk, 1)) also the scan of
    v = ones: (y, state, nrm (B, H, S, 1) in q's dtype, n (B, H, dk, 1) fp32)."""
    build.refuse_grad("gated_linear_scan", q, k, v, log_a, initial_state, initial_normaliser)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or log_a.dim() != 3:
        raise ValueError("gated_linear_scan: q, k, v must be (B, H, S, d), log_a (B, H, S)")
    B, H, S, dk = q.shape
    dv = v.shape[-1]
    if k.shape != q.shape or v.shape[:3] != (B, H, S) or log_a.shape != (B, H, S):
        raise ValueError(f"gated_linear_scan: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} log_a{tuple(log_a.shape)}")
    if min(B, H, S, dv) < 1 or not 1 <= dk <= MAX_DK:
        raise ValueError(f"gated_linear_scan: need B, H, S, dv >= 1 and 1 <= dk <= {MAX_DK}")
    if chunk < 1:
        raise ValueError(f"gated_linear_scan: chunk {chunk} < 1")
    if initial_normaliser is not None and not normaliser:
        raise ValueError("gated_linear_scan: initial_normaliser needs normaliser=True")
    tensors = [("q", q), ("k", k), ("v", v), ("log_a", log_a)]
    states = [("initial_state", initial_state, (B, H, dk, dv)),
              ("initial_normaliser", initial_normaliser, (B, H, dk, 1))]
    tensors += [(name, t) for name, t, _ in states if t is not None]
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"gated_linear_scan: {name} must be on q's CUDA device, "
                             f"got {t.device}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"gated_linear_scan: {name} dtype {t.dtype} != q's {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"gated_linear_scan: dtype {q.dtype}; need fp32 or bf16")
    if log_a.dtype != torch.float32:
        raise ValueError(f"gated_linear_scan: log_a dtype {log_a.dtype}; need fp32")
    for name, t, shape in states:
        if t is None:
            continue
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"gated_linear_scan: {name} must be fp32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"gated_linear_scan: {name} must be contiguous")
    kind = variant(q, k, v)
    tile = (tile_columns(B, H, dv + int(normaliser), build.sm_count(q.device))
            if kind == "mma" else 0)
    dev = q.device
    y = torch.empty((B, H, S, dv), dtype=q.dtype, device=dev)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=dev)
    nrm = torch.empty((B, H, S, 1), dtype=q.dtype, device=dev) if normaliser else None
    n = torch.empty((B, H, dk, 1), dtype=torch.float32, device=dev) if normaliser else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(), ptr(initial_state),
        ptr(initial_normaliser), y.data_ptr(), state.data_ptr(), ptr(nrm), ptr(n),
        B, H, S, dk, dv, *q.stride(), *k.stride(), *v.stride(), *log_a.stride(),
        _DTYPE_CODES[q.dtype], VARIANT_CODES[kind], tile,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, f"gated_linear_scan ({kind})")
    build.count_launch(__name__, kind)
    return (y, state, nrm, n) if normaliser else (y, state)
