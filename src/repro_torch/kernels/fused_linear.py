"""Wrapper of the hand-written CUDA fused linear kernel
(`csrc/fused_linear.cu`), and its plain PyTorch version.

Replaces the reference's Pallas TPU kernel
`repro/kernels/fused_linear.py::fused_linear`, the compute hot spot of the
paper's Test Case 2 (heterogeneous inference): ``y = act(x @ W + b)`` with
an fp32 accumulator, act one of none / relu / gelu (tanh form). The source
holds four variants, and `variant` picks one by an explicit rule (nothing is
caught and retried):

* ``wgmma``: bf16 with K and N multiples of 8 and x, W 16-byte aligned (what
  TMA needs): tensor cores fed by TMA, 128 x 256 tiles.
* ``simt_small``: fp32, and the bf16 that ``wgmma`` does not take, when W
  whole and `SMALL_ROWS` rows of x fit `SMALL_SMEM_BYTES` of shared memory
  and the product has fewer 64 x 64 output tiles than the card has SMs:
  Test Case 2's products (256 x 64 @ 64 x 32, then 256 x 32 @ 32 x 10). A
  block of 16 rows stages W and its rows of x with one round of loads, then
  runs exact fp32 FMA chains; ragged N and K cost nothing.
* ``simt_tiled``: fp32 with K and N multiples of 4, x, W, b 16-byte aligned,
  and at least one wave of 128 x 128 tiles (a block each on every SM of the
  card: 132 on the H100): exact fp32 FMA, ``cp.async`` double buffering.
* ``simt``: everything else (unaligned or ragged widths of products too
  large for ``simt_small``): exact fp32 FMA on 64 x 64 tiles, ragged M, N, K
  masked.

fp32 never runs on TF32. The wrapper checks device, dtype, shape and
contiguity, allocates the output with `torch.empty`, launches on the current
stream without synchronising, and counts its launches in `launches` and, by
variant, in `variant_launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build

ACTS = {"none": 0, "relu": 1, "gelu": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_VARIANT_CODES = {"simt": 0, "simt_tiled": 1, "wgmma": 2, "simt_small": 3}
#: rows of x a simt_small block stages beside the whole of W
SMALL_ROWS = 16
#: shared memory simt_small's block may use: W (rounded up to 16 bytes) and
#: `SMALL_ROWS` rows of x, in x's dtype
SMALL_SMEM_BYTES = 48 * 1024

#: Kernel launches made by this process (one per call of `fused_linear`).
launches = 0
#: The same launches by variant.
variant_launches = {name: 0 for name in _VARIANT_CODES}


@functools.cache
def _entry():
    fn = build.load().fused_linear_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def small_smem_bytes(K: int, N: int, elem: int) -> int:
    """Shared memory of a simt_small block: W whole, rounded up to 16
    bytes, and `SMALL_ROWS` rows of x, `elem` bytes an element."""
    return -(-K * N * elem // 16) * 16 + SMALL_ROWS * K * elem


def variant(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel variant `fused_linear` launches for these operands (see
    the module note); a rule on dtype, shape and alignment, and on the
    multiprocessors of x's card: ``simt_small`` for a product under one
    wave of 64 x 64 tiles whose W fits a block, ``simt_tiled`` for fp32 from
    one wave of 128 x 128 tiles (the 64 x 64 tiles of ``simt`` give the
    products in between more blocks)."""
    M, K = x.shape
    N = w.shape[1]
    if x.dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 and _aligned(x, w):
        return "wgmma"
    if (small_smem_bytes(K, N, x.element_size()) <= SMALL_SMEM_BYTES
            and -(-M // 64) * -(-N // 64) < build.sm_count(x.device)):
        return "simt_small"
    if (x.dtype == torch.float32 and K % 4 == 0 and N % 4 == 0 and _aligned(x, w, b)
            and -(-M // 128) * -(-N // 128) >= build.sm_count(x.device)):
        return "simt_tiled"
    return "simt"


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
    build.refuse_grad("fused_linear", x, w, b)
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
    kind = variant(x, w, b)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _entry()(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), M, N, K,
        _DTYPE_CODES[x.dtype], ACTS[act], _VARIANT_CODES[kind],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(err, f"fused_linear ({kind})")
    build.count_launch(__name__, kind)
    return y
