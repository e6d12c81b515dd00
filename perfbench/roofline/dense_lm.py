"""The model's own work, for a share of the card's peak (`mfu`): two
operations a weight of a matrix product and a token (the embedding is a
lookup, not a product), plus causal attention's four a kept pair, head and
head dim; a training step three times the forward. No recomputation is
counted: a step that recomputes does not get credit for it."""
from __future__ import annotations

from perfbench.roofline.causal import pairs


def _hd(arch) -> int:
    return arch.head_dim or arch.d_model // arch.num_heads


def layer_params(arch) -> int:
    """Weights of one layer's matrix products."""
    d, H, KV, hd, f = arch.d_model, arch.num_heads, arch.num_kv_heads, _hd(arch), arch.d_ff
    return 2 * d * H * hd + 2 * d * KV * hd + (3 if arch.act == "silu" else 2) * d * f


def head_params(arch) -> int:
    return arch.d_model * arch.vocab_size


def attention_flops(arch, kept_pairs: int) -> int:
    """One layer's forward attention over `kept_pairs` (query, key) pairs."""
    return 4 * _hd(arch) * arch.num_heads * kept_pairs


def prefill_flops(arch, prompt: int) -> int:
    """A prompt's prefill: every layer over every position, the LM head
    over the last one (the only logits a prefill makes)."""
    L = arch.num_layers
    return L * (2 * layer_params(arch) * prompt + attention_flops(arch, pairs(prompt, prompt))) \
        + 2 * head_params(arch)


def tick_flops(arch, position: int) -> int:
    """One decoded token at `position` (attending to position + 1 keys)."""
    L = arch.num_layers
    return L * (2 * layer_params(arch) + attention_flops(arch, position + 1)) \
        + 2 * head_params(arch)


def train_step_flops(arch, batch: int, seq: int) -> int:
    """Forward and backward of a step over batch x seq tokens."""
    L = arch.num_layers
    fwd = L * (2 * layer_params(arch) * batch * seq
               + attention_flops(arch, batch * pairs(seq, seq))) \
        + 2 * head_params(arch) * batch * seq
    return 3 * fwd
