"""Kernel entry points the models call, dispatched by the tensor's device.

* CPU tensor: the plain PyTorch version (`ref`, `fused_linear_ref`).
* CUDA tensor: the hand-written kernel. If it cannot build or launch, the
  call raises; nothing falls back to the plain version.

Mirrors the reference's `repro/kernels/ops.py`, where an ``impl=`` argument
chose between the oracle and the Pallas kernel; here the device decides.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import build
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import fused_linear as _linear
from . import linear_scan as _scan
from . import paged_decode_attention as _paged
from . import ref


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def attention(q, k, v, *, causal: bool = True, window: int = 0, prefix_len: int = 0,
              q_offset: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd)."""
    if _on_cuda(q, "attention"):
        return _flash.flash_attention(
            q, k, v, causal=causal, window=window, prefix_len=prefix_len,
            q_offset=q_offset, scale=scale,
        )
    return ref.attention(
        q, k, v, causal=causal, window=window, prefix_len=prefix_len,
        q_offset=q_offset, scale=scale,
    )


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, hd); k/v_cache: (B, S, KV, hd); pos: scalar or (B,) int32
    -> (B, H, hd). Validity is slot <= pos; `window` reaches the plain
    version only, which ignores it as the reference's oracle does (ring
    buffers are fully valid through the caller's clamp), so the kernel takes
    none."""
    if _on_cuda(q, "decode_attention"):
        return _decode.decode_attention(q, k_cache, v_cache, pos, scale=scale)
    return ref.decode_attention(q, k_cache, v_cache, pos, window=window, scale=scale)


def paged_decode_attention(q, k_pool, v_pool, page_table, pos, *, window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, hd); k/v_pool: (P, page, KV, hd); page_table: (B, n_pages);
    pos: (B,) -> (B, H, hd)."""
    if _on_cuda(q, "paged_decode_attention"):
        return _paged.paged_decode_attention(
            q, k_pool, v_pool, page_table, pos, window=window, scale=scale
        )
    return ref.paged_decode_attention(
        q, k_pool, v_pool, page_table, pos, window=window, scale=scale
    )


def fused_linear(x, w, b, *, act: str = "none") -> torch.Tensor:
    """act(x @ w + b): x (M, K), w (K, N), b (N,) -> (M, N) in x's dtype."""
    if _on_cuda(x, "fused_linear"):
        return _linear.fused_linear(x, w, b, act=act)
    return _linear.fused_linear_ref(x, w, b, act=act)


def gated_linear_scan(q, k, v, log_a, *, chunk: int = 128, initial_state=None,
                      normaliser: bool = False,
                      initial_normaliser=None) -> Tuple[torch.Tensor, ...]:
    """q, k: (B, H, S, dk); v: (B, H, S, dv); log_a: (B, H, S) fp32;
    initial_state: None (zeros) or fp32 (B, H, dk, dv) -> (y (B, H, S, dv),
    final state (B, H, dk, dv) fp32). The kernel takes a carried state as
    the reference's ``ops`` call does (its Pallas wrapper sends that case to
    the oracle) and any S; `chunk` shapes the plain version only, which keeps
    the reference's ``S % chunk == 0``. ``normaliser=True`` adds the scan of
    v = ones from `initial_normaliser` (None or fp32 (B, H, dk, 1)):
    (y, state, nrm (B, H, S, 1), n (B, H, dk, 1)), in the kernel's one
    launch; the plain version makes the reference's two calls."""
    if _on_cuda(q, "gated_linear_scan"):
        return _scan.gated_linear_scan(q, k, v, log_a, chunk=chunk, initial_state=initial_state,
                                       normaliser=normaliser,
                                       initial_normaliser=initial_normaliser)
    if normaliser:
        return ref.gated_linear_scan_normalised(q, k, v, log_a, chunk=chunk,
                                                initial_state=initial_state,
                                                initial_normaliser=initial_normaliser)
    if initial_normaliser is not None:
        raise ValueError("gated_linear_scan: initial_normaliser needs normaliser=True")
    return ref.gated_linear_scan(q, k, v, log_a, chunk=chunk, initial_state=initial_state)


_KERNELS = {
    "flash_attention": _flash,
    "paged_decode_attention": _paged,
    "decode_attention": _decode,
    "fused_linear": _linear,
    "gated_linear_scan": _scan,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far in this process, by kernel name."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def variant_counts() -> Dict[str, Dict[str, int]]:
    """Launches so far by kernel variant (every kernel picks one of its
    variants by an explicit rule)."""
    return {name: dict(mod.variant_launches) for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    """Zero every launch count, the counts by variant included."""
    with build.COUNT_LOCK:
        for mod in _KERNELS.values():
            mod.launches = 0
            for kind in mod.variant_launches:
                mod.variant_launches[kind] = 0
