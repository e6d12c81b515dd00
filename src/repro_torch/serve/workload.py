"""Synthetic serving workloads: requests with varied prompt/decode lengths,
the traffic shape continuous batching exists for. Port of
`repro/serve/workload.py::synthetic_requests`: the same numpy RNG calls in
the same order, so a seed gives the reference's requests."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .scheduler import Request


def synthetic_requests(
    vocab_size: int,
    n: int,
    *,
    prompt_range: Tuple[int, int],
    steps_range: Tuple[int, int],
    seed: int = 0,
    rid_prefix: str = "req",
) -> List[Request]:
    """`n` requests with prompt lengths drawn from [lo, hi) of
    `prompt_range` and decode budgets from [lo, hi) of `steps_range`."""
    rng = np.random.default_rng(seed)
    requests = []
    for i in range(n):
        plen = int(rng.integers(*prompt_range))
        steps = int(rng.integers(*steps_range))
        prompt = rng.integers(1, vocab_size, (plen,), dtype=np.int32).tolist()
        requests.append(Request(rid=f"{rid_prefix}-{i}", prompt=prompt, max_new_tokens=steps))
    return requests
