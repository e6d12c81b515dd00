"""Wrapper of the hand-written CUDA fused linear kernel
(`csrc/fused_linear.cu`), and its plain PyTorch version.

Replaces the reference's Pallas TPU kernel
`repro/kernels/fused_linear.py::fused_linear`, the compute hot spot of the
paper's Test Case 2 (heterogeneous inference): ``y = act(x @ W + b)`` with
an fp32 accumulator, act one of none / relu / gelu (tanh form). The kernel
tiles the output 64 x 64, loops over K in slices of 16 through shared
memory, accumulates with fp32 FMAs (never TF32) and applies the bias and the
activation before its one store; ragged M, N, K are masked in the kernel, so
no caller pads. On the H100 the Test Case 2 shapes are bound by launch
overhead and large shapes by operations (see the source).

The wrapper checks device, dtype, shape and contiguity, allocates the output
with `torch.empty`, launches on the current stream without synchronising,
and counts its launches in `launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

ACTS = {"none": 0, "relu": 1, "gelu": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches made by this process (one per call of `fused_linear`).
launches = 0


@functools.cache
def _entry():
    fn = build.load().fused_linear_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_linear_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                     act: str = "none") -> torch.Tensor:
    """Plain version (the reference's `fused_linear_ref`): fp32 product, bias
    and activation, cast back to x's dtype."""
    if act not in ACTS:
        raise ValueError(f"fused_linear: act {act!r} not in {sorted(ACTS)}")
    y = x.float() @ w.float() + b.float()
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "gelu":
        y = F.gelu(y, approximate="tanh")  # jax.nn.gelu's default form
    return y.to(x.dtype)


def fused_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                 act: str = "none") -> torch.Tensor:
    """x: (M, K); w: (K, N); b: (N,) -> act(x @ w + b) (M, N) in x's dtype,
    on CUDA."""
    global launches
    if act not in ACTS:
        raise ValueError(f"fused_linear: act {act!r} not in {sorted(ACTS)}")
    if x.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError("fused_linear: x must be (M, K), w (K, N), b (N,)")
    M, K = x.shape
    Kw, N = w.shape
    if Kw != K or b.shape[0] != N or M < 1 or N < 1 or K < 1:
        raise ValueError(f"fused_linear: shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"b{tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"fused_linear: {name} must be on x's CUDA device, got {t.device}")
        if t.dtype not in _DTYPE_CODES or t.dtype != x.dtype:
            raise ValueError(f"fused_linear: {name} dtype {t.dtype}; need fp32/bf16 for all")
        if not t.is_contiguous():
            raise ValueError(f"fused_linear: {name} must be contiguous")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _entry()(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), M, N, K,
        _DTYPE_CODES[x.dtype], ACTS[act], torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, "fused_linear")
    launches += 1
    return y
