"""Kernel entry points the models call, dispatched by the tensor's device.

* CPU tensor: the plain PyTorch version (`ref`, `fused_linear_ref`).
* CUDA tensor: the hand-written kernel. If it cannot build or launch, the
  call raises; nothing falls back to the plain version.

* ``meta`` tensor (a dry run's abstract input): the plain version, which
  only propagates shapes there.
* DTensor (a mesh): the same call on the local shards through `local_map`
  (`kernels/sharded.py`); no DTensor reaches a kernel wrapper.

Mirrors the reference's `repro/kernels/ops.py`, where an ``impl=`` argument
chose between the oracle and the Pallas kernel; here the device decides.
``impl`` remains for the reference's XLA-level twins (`kernels/blocked.py`):
``attention(..., impl="blocked")`` and ``gated_linear_scan(...,
impl="sequential")`` take them on the CPU route, where the plain version
would run; on CUDA the kernel wins, as the reference's Pallas kernel wins
over its blocked path.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import blocked as _blocked
from . import build
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import fused_linear as _linear
from . import linear_scan as _scan
from . import paged_decode_attention as _paged
from . import ref
from . import sharded


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def attention(q, k, v, *, causal: bool = True, window: int = 0, prefix_len: int = 0,
              q_offset: int = 0, scale: Optional[float] = None,
              impl: str = "ref") -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) -> (B, Sq, H, hd). On CUDA
    under grad mode with an input that requires grad (training), the flash
    forward with its log-sum-exp and, for the gradient, the backward kernel
    (`FlashAttentionFn`); otherwise the forward alone. On the CPU the plain
    version, which autograd differentiates, or with ``impl="blocked"`` and
    an int window the blocked twin."""
    kw = dict(causal=causal, window=window, prefix_len=prefix_len, q_offset=q_offset,
              scale=scale)
    if sharded.is_dtensor(q):
        return sharded.attention(attention, q, k, v, impl=impl, **kw)
    if _on_cuda(q, "attention"):
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return _flash.FlashAttentionFn.apply(q, k, v, _flash.flash_attention_with_lse,
                                                 _flash.flash_attention_backward, kw)
        return _flash.flash_attention(q, k, v, **kw)
    if impl == "blocked" and isinstance(window, int):
        return _blocked.attention_blocked(q, k, v, **kw)
    return ref.attention(q, k, v, **kw)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, hd); k/v_cache: (B, S, KV, hd); pos: scalar or (B,) int32
    -> (B, H, hd). Validity is slot <= pos; `window` reaches the plain
    version only, which ignores it as the reference's oracle does (ring
    buffers are fully valid through the caller's clamp), so the kernel takes
    none."""
    if sharded.is_dtensor(q):
        return sharded.decode_attention(decode_attention, q, k_cache, v_cache, pos,
                                        window=window, scale=scale)
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
                      normaliser: bool = False, initial_normaliser=None,
                      impl: str = "ref") -> Tuple[torch.Tensor, ...]:
    """q, k: (B, H, S, dk); v: (B, H, S, dv); log_a: (B, H, S) fp32;
    initial_state: None (zeros) or fp32 (B, H, dk, dv) -> (y (B, H, S, dv),
    final state (B, H, dk, dv) fp32). The kernel takes a carried state as
    the reference's ``ops`` call does (its Pallas wrapper sends that case to
    the oracle) and any S; `chunk` shapes the plain version only, which keeps
    the reference's ``S % chunk == 0``. ``normaliser=True`` adds the scan of
    v = ones from `initial_normaliser` (None or fp32 (B, H, dk, 1)):
    (y, state, nrm (B, H, S, 1), n (B, H, dk, 1)), in the kernel's one
    launch; the plain version makes the reference's two calls. On CUDA
    under grad mode with an input that requires grad (training), the
    forward kernel under `GatedLinearScanFn`, whose gradient is the
    backward kernel; on the CPU the plain version, which autograd
    differentiates; with ``impl="sequential"`` the sequential-chunk twin
    (`kernels/blocked.py`)."""
    if sharded.is_dtensor(q):
        return sharded.gated_linear_scan(
            gated_linear_scan, q, k, v, log_a, initial_state, initial_normaliser,
            n_out=4 if normaliser else 2, chunk=chunk, normaliser=normaliser, impl=impl)
    if _on_cuda(q, "gated_linear_scan"):
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (q, k, v, log_a, initial_state, initial_normaliser)):
            return _scan.GatedLinearScanFn.apply(
                q, k, v, log_a, initial_state, initial_normaliser, _scan.gated_linear_scan,
                _scan.gated_linear_scan_backward, dict(chunk=chunk, normaliser=normaliser))
        return _scan.gated_linear_scan(q, k, v, log_a, chunk=chunk, initial_state=initial_state,
                                       normaliser=normaliser,
                                       initial_normaliser=initial_normaliser)
    if initial_normaliser is not None and not normaliser:
        raise ValueError("gated_linear_scan: initial_normaliser needs normaliser=True")
    if impl == "sequential":
        scan = _blocked.gated_linear_scan_sequential
        y, state = scan(q, k, v, log_a, chunk=chunk, initial_state=initial_state)
        if not normaliser:
            return y, state
        ones = torch.ones((*q.shape[:3], 1), dtype=q.dtype, device=q.device)
        return (y, state, *scan(q, k, ones, log_a, chunk=chunk,
                                initial_state=initial_normaliser))
    if normaliser:
        return ref.gated_linear_scan_normalised(q, k, v, log_a, chunk=chunk,
                                                initial_state=initial_state,
                                                initial_normaliser=initial_normaliser)
    return ref.gated_linear_scan(q, k, v, log_a, chunk=chunk, initial_state=initial_state)


_KERNELS = {
    "flash_attention": _flash,
    "flash_attention_bwd": _flash.backward,
    "paged_decode_attention": _paged,
    "decode_attention": _decode,
    "fused_linear": _linear,
    "gated_linear_scan": _scan,
    "gated_linear_scan_bwd": _scan.backward,
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
