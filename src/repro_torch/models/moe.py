"""Mixture-of-Experts FFN with sort-based capacity dispatch. Port of
`repro/models/moe.py`.

Tokens are sorted by destination expert (a stable sort, as `jnp.argsort`),
scattered into a dense (E, C, d) buffer, run through grouped expert products
and gathered back, weighted by their router gates. Rows beyond an expert's
capacity C are dropped: their tokens pass through the residual stream only.
C follows the reference bit for bit (`capacity`), since it decides which
rows drop. The grouped products are plain matrix products (`torch.bmm`), as
the reference computes them outside any Pallas kernel.

Under a mesh (DTensor activations and expert weights split over the
``model`` axis) the dispatch intermediates are pinned to mesh axes with
`sharding.ambient.constrain` where the reference pins them: rows to the
data axes, expert buffers to ``model``. The routing's integer bookkeeping
(sort, counts, positions) runs on the whole picks as plain tensors (DTensor
has no rule for such data-dependent ops), so routing and capacity are the
global batch's, as in the reference. Without a mesh the pins do nothing.
Training adds the reference's Switch-style load-balance loss
(`moe_load_balance_loss`) over the router statistics `moe_ffn` returns.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.sharding.ambient import constrain
from .common import ParamInit, act_fn


def init_moe(pi: ParamInit, cfg: ArchConfig):
    """One layer's experts (E, d, f) / (E, f, d), drawn an expert at a time,
    and the router (d, E) in fp32 whatever the storage dtype: the reference
    reads it as fp32, and a rounded router can flip a top-k pick."""
    d, f, E = cfg.d_model, cfg.expert_d_ff, cfg.num_experts
    tree = {
        "router": pi.normal((d, E), fan_in=d, dtype=torch.float32),
        "w_up": pi.stacked_normal((E, d, f), fan_in=d),
        "w_down": pi.stacked_normal((E, f, d), fan_in=f),
    }
    if cfg.act == "silu":
        tree["w_gate"] = pi.stacked_normal((E, d, f), fan_in=d)
    return tree


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Per-expert capacity, rounded up to a multiple of 8 lanes."""
    c = math.ceil(n_tokens * cfg.experts_per_token / cfg.num_experts * cfg.capacity_factor)
    return max(8, ((c + 7) // 8) * 8)


def moe_ffn(cfg: ArchConfig, p, x: torch.Tensor, *,
            dropless: bool = False) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (y, aux). aux holds the router's probabilities and
    picks (the load-balance loss's inputs) and ``dropped``, (B*S, k) bool:
    which of each token's picks fell past its expert's capacity.

    ``dropless`` raises the capacity to the token count, so no row drops:
    the exact equivalent, batched, of the reference's slot decoder, which
    vmaps a B=1 step over the slots (one token's k picks are k distinct
    experts, and C = 8 >= k holds them all)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    N = B * S
    C = capacity(cfg, N)
    if dropless:
        C = max(C, -(-N // 8) * 8)
    cd = x.dtype
    act = act_fn(cfg.act)
    dev = x.device

    xf = x.reshape(N, d)
    router_logits = xf.float() @ p["router"].float()
    probs = torch.softmax(router_logits, dim=-1)  # (N, E)
    gates, idx = torch.topk(probs, k, dim=-1)  # (N, k)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    # ---- sort-based dispatch ------------------------------------------------
    flat_expert = _full(idx.reshape(N * k))
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    token_of = torch.div(order, k, rounding_mode="floor")  # originating token per sorted row

    # position of each row within its expert group
    # (a static-shape count: it also runs on a dry run's meta tensors)
    counts = torch.zeros(E, dtype=torch.long, device=dev).index_add_(
        0, sorted_expert, torch.ones_like(sorted_expert))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(N * k, device=dev) - starts[sorted_expert]
    keep = pos < C
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))

    x_rows = constrain(xf[token_of], ("pod", "data"))  # (N*k, d) gather
    x_rows = torch.where(keep[:, None], x_rows, torch.zeros((), dtype=cd, device=dev))
    buf = torch.zeros((E, C, d), dtype=cd, device=dev)
    buf = constrain(buf.index_put((sorted_expert, pos_c), x_rows, accumulate=True), "model")

    # ---- expert computation (grouped products over the expert dim) ---------
    up = torch.bmm(buf, p["w_up"].to(cd))
    if "w_gate" in p:
        h = act(torch.bmm(buf, p["w_gate"].to(cd))) * up
    else:
        h = act(up)
    out_buf = constrain(torch.bmm(h, p["w_down"].to(cd)), "model")  # (E, C, d)

    # ---- combine ------------------------------------------------------------
    # back to token order: row t * k + j is token t's j-th pick; each token
    # gathers exactly its k rows, so summing them is the reference's fp32
    # scatter-add, in a fixed order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(N * k, device=dev)
    y_rows = out_buf[sorted_expert, pos_c][inv]  # (N*k, d)
    kept = keep[inv]
    y_rows = constrain(torch.where(kept[:, None], y_rows, torch.zeros((), dtype=cd, device=dev)),
                       ("pod", "data"))
    contrib = y_rows.float() * gates.reshape(N * k)[:, None]
    y = constrain(contrib.reshape(N, k, d).sum(dim=1), ("pod", "data"))

    aux = {"router_probs": probs, "expert_indices": idx, "dropped": ~kept.reshape(N, k)}
    return y.reshape(B, S, d).to(cd), aux


def _full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor (every rank the same); a
    plain tensor as is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def moe_load_balance_loss(router_probs: torch.Tensor, expert_indices: torch.Tensor,
                          num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss, ``num_experts * sum(f_e * p_e)``: f_e the
    mean count of picks of expert e a token, p_e its mean router probability
    (the reference's `repro/models/common.py::moe_load_balance_loss`).
    router_probs: (..., E); expert_indices: (..., k)."""
    one_hot = torch.nn.functional.one_hot(expert_indices.long(), num_experts).float()
    lead = tuple(range(one_hot.dim() - 2))
    tokens_per_expert = torch.mean(one_hot.sum(dim=-2), dim=lead)
    router_mean = torch.mean(router_probs, dim=tuple(range(router_probs.dim() - 1)))
    return num_experts * torch.sum(tokens_per_expert * router_mean)
