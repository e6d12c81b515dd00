"""`flash_attention`'s backward (`csrc/flash_attention_bwd.cu`, its three or
four launches a call: row statistics, dK / dV, dQ, the reduction): the work
of one call from its shapes. q, k, v, the output, its gradient and the
log-sum-exp read once, dq, dk, dv written once; five products over the kept
(query, key) pairs, two operations each a head dim (the scores again, dP,
dV, dQ, dK)."""
from __future__ import annotations

from perfbench.roofline.causal import pairs


def matches(name: str) -> bool:
    return "flash_bwd_" in name


def work(*, B: int, Sq: int, Skv: int, H: int, KV: int, hd: int, elem: int,
         causal: bool = True) -> tuple:
    """(FLOP, bytes) of one call."""
    kept = pairs(Sq, Skv) if causal else Sq * Skv
    flops = 10 * hd * H * B * kept
    nbytes = elem * (4 * B * Sq * H * hd + 4 * B * Skv * KV * hd) + 4 * B * Sq * H
    return flops, nbytes
