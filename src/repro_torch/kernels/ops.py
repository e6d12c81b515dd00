"""Kernel entry points the models call, dispatched by the tensor's device.

* CPU tensor: the plain PyTorch version (`ref`).
* CUDA tensor: the hand-written kernel. If it cannot build or launch, the
  call raises; nothing falls back to the plain version.

Mirrors the reference's `repro/kernels/ops.py`, where an ``impl=`` argument
chose between the oracle and the Pallas kernel; here the device decides.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import flash_attention as _flash
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


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far in this process, by kernel name."""
    return {
        "flash_attention": _flash.launches,
        "paged_decode_attention": _paged.launches,
    }


def reset_launch_counts() -> None:
    _flash.launches = 0
    _paged.launches = 0
