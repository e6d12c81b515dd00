"""Published peaks of the cards the benchmark knows, by the name that
`torch.cuda.get_device_name()` gives: NVIDIA's data sheets, dense rates
without sparsity, at the card's full power limit."""
from __future__ import annotations

from typing import Optional

PEAKS = {
    # H100 SXM5
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float16": 989e12, "tfloat32": 495e12,
                              "float32": 67e12, "bytes_per_s": 3.35e12},
    "NVIDIA H100 PCIe": {"bfloat16": 756e12, "float16": 756e12, "tfloat32": 378e12,
                         "float32": 51e12, "bytes_per_s": 2.0e12},
}


def for_device(kind: str) -> Optional[dict]:
    return PEAKS.get(kind)


def bound_s(flops: float, nbytes: float, peaks: dict, dtype: str) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate of `dtype` and bytes over the memory bandwidth."""
    return max(flops / peaks[dtype], nbytes / peaks["bytes_per_s"])
