"""Error-feedback int8 gradient compression. Port of
`repro/train/compression.py`.

Each gradient leaf is quantised to int8 with one scale a tensor; the
quantisation residual is carried to the next step in an error-feedback
accumulator, so the bias vanishes over steps (EF-SGD). On one device the
round trip models the wire format of a cross-replica reduction: the int8
tensor is what would cross the links (multi-device is a later slice).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .tree import tree_map, tree_unzip


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)  # half to even, as jnp
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_decompress(grads, ef_state):
    """The int8 round trip of every gradient leaf, carrying residuals.
    Returns (decompressed fp32 grads, new ef_state)."""

    def per_leaf(g, e):
        g32 = g.float() + e
        deq = dequantize_int8(*quantize_int8(g32))
        return deq, g32 - deq

    return tree_unzip(tree_map(per_leaf, grads, ef_state), 2)

