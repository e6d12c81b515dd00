"""Wrapper of the hand-written CUDA chunkwise gated linear scan
(`csrc/linear_scan.cu`).

Replaces the reference's Pallas TPU kernel
`repro/kernels/linear_scan.py::gated_linear_scan`:

    S_t = a_t * S_{t-1} + k_t^T v_t ;  y_t = q_t @ S_t ;  a_t = exp(log_a_t)

with the decay in log space in fp32 and the (dk, dv) state accumulated in
fp32. The kernel gives each block a dk x 32 column slab of the state in
shared memory (xlstm's 384 x 384 fp32 state does not fit one block) and
walks the sequence in chunks of 64 positions, masking a ragged last chunk,
so any S runs; `chunk` is the reference's tiling knob and does not change
the result (`tests/test_kernels.py::test_chunk_size_invariance`), so the
kernel accepts and ignores it.

Carried state: the kernel takes an optional fp32 `initial_state` and starts
from it in place of zeros. This is the function the reference's
``ops.gated_linear_scan(..., initial_state=s0)`` computes (its Pallas
wrapper routes that case to the jnp oracle), not a new feature: it lets the
xlstm serving path (prefill from zero states, one-position decode steps) run
on this kernel too.

The wrapper checks device, dtype and shape, passes q, k, v and log_a by
their strides (head-split views of a projection need no copy), allocates y
and the final state with `torch.empty`, launches on the current stream
without synchronising, and counts its launches in `launches`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build

MAX_DK = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches made by this process (one per call of `gated_linear_scan`).
launches = 0


@functools.cache
def _entry():
    fn = build.load().gated_linear_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 15
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def gated_linear_scan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    log_a: torch.Tensor,
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B, H, S, dk); v: (B, H, S, dv) (fp32 or bf16, one dtype);
    log_a: (B, H, S) fp32; initial_state: None or contiguous fp32
    (B, H, dk, dv). Returns (y (B, H, S, dv) in q's dtype, final state
    (B, H, dk, dv) fp32), on CUDA."""
    global launches
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
    tensors = [("q", q), ("k", k), ("v", v), ("log_a", log_a)]
    if initial_state is not None:
        tensors.append(("initial_state", initial_state))
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"gated_linear_scan: {name} must be on q's CUDA device, got {t.device}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"gated_linear_scan: {name} dtype {t.dtype} != q's {q.dtype}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"gated_linear_scan: dtype {q.dtype}; need fp32 or bf16")
    if log_a.dtype != torch.float32:
        raise ValueError(f"gated_linear_scan: log_a dtype {log_a.dtype}; need fp32")
    if initial_state is not None:
        if initial_state.shape != (B, H, dk, dv) or initial_state.dtype != torch.float32:
            raise ValueError(f"gated_linear_scan: initial_state must be fp32 {(B, H, dk, dv)}, "
                             f"got {initial_state.dtype} {tuple(initial_state.shape)}")
        if not initial_state.is_contiguous():
            raise ValueError("gated_linear_scan: initial_state must be contiguous")
    y = torch.empty((B, H, S, dv), dtype=q.dtype, device=q.device)
    state = torch.empty((B, H, dk, dv), dtype=torch.float32, device=q.device)
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
        initial_state.data_ptr() if initial_state is not None else None,
        y.data_ptr(), state.data_ptr(), B, H, S, dk, dv,
        *q.stride(), *k.stride(), *v.stride(), *log_a.stride(),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "gated_linear_scan")
    launches += 1
    return y, state
