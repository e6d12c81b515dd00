"""`flash_attention`'s forward (`csrc/flash_attention.cu`, every variant:
`simt`, `wgmma`, `tf32x3`): the work of one call from its shapes. q, k, v
read once and the output written once (the log-sum-exp too where the call
returns it); four operations a kept (query, key) pair and head dim, two for
q . k and two for p . v."""
from __future__ import annotations

from perfbench.roofline.causal import pairs

NAMES = ("flash_attention_kernel", "flash_attention_wgmma_kernel",
         "flash_attention_tf32x3_kernel")


def matches(name: str) -> bool:
    return any(n in name for n in NAMES)


def work(*, B: int, Sq: int, Skv: int, H: int, KV: int, hd: int, elem: int,
         causal: bool = True, lse: bool = False) -> tuple:
    """(FLOP, bytes) of one call."""
    kept = pairs(Sq, Skv) if causal else Sq * Skv
    flops = 4 * hd * H * B * kept
    nbytes = elem * (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd) + (4 * B * Sq * H if lse else 0)
    return flops, nbytes
