"""`paged_decode_attention` (`csrc/paged_decode_attention.cu` on the decode
core, the `PagedRows` instantiations of `decode_kernel` and
`decode_mma_kernel`): the work of one call, one tick of one layer, from the
positions of the slots that decode. Each valid key and value read once, q
read and the output written once; four operations a valid position, query
head and head dim."""
from __future__ import annotations

from typing import Sequence


def matches(name: str) -> bool:
    return "PagedRows" in name and ("decode_kernel" in name or "decode_mma_kernel" in name)


def work(*, valid: Sequence[int], H: int, KV: int, hd: int, elem: int) -> tuple:
    """(FLOP, bytes) of one call over slots with `valid` positions each."""
    n = sum(valid)
    flops = 4 * H * hd * n
    nbytes = elem * (2 * n * KV * hd + 2 * len(valid) * H * hd)
    return flops, nbytes
