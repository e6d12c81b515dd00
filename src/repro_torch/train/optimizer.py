"""Functional optimizers: AdamW and Adafactor, with global-norm clipping and
a warmup + cosine schedule. Port of `repro/train/optimizer.py`: plain
functions on trees of tensors (no `torch.optim`), the same arithmetic in
fp32, the step count a 0-d int32 tensor on the parameters' device. The
state mirrors the parameter tree. Updates run under `torch.no_grad()` and
return new tensors; nothing is updated in place.

Adafactor's statistics are per leaf: its factored second moment averages
rows and columns of a leaf, and its update is clipped by the leaf's RMS.
The reference's leaves are its layer stacks, so `train/train_step.py`
hands Adafactor the port's parameters stacked the same way
(`models/bridge.py::stack_params`) and its state keeps that layout.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .tree import tree_leaves, tree_map, tree_unzip


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | adafactor
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    factored_dims_min: int = 2  # factor second moment for >=2D params


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Learning rate at `step` (an int or a tensor), fp32: linear warmup,
    then cosine decay to ``min_lr_ratio``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cosine = 0.5 * (1 + torch.cos(math.pi * progress))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cosine
    return cfg.learning_rate * warm * decay


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(grads, clip: float):
    """(grads scaled to a global norm of at most `clip`, the norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _count_like(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def adamw_init(cfg: OptimizerConfig, params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": _count_like(params)}


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, state, params):
    count = state["count"] + 1
    lr = schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    bias1, bias2 = 1 - b1**c, 1 - b2**c

    def upd(g, m, n, p):
        g32, p32 = g.float(), p.float()
        m_new = b1 * m + (1 - b1) * g32
        n_new = b2 * n + (1 - b2) * torch.square(g32)
        step = (m_new / bias1) / (torch.sqrt(n_new / bias2) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr * step).to(p.dtype), m_new, n_new

    new_params, mu, nu = tree_unzip(tree_map(upd, grads, state["mu"], state["nu"], params), 3)
    return new_params, {"mu": mu, "nu": nu, "count": count}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; no first moment)
# ---------------------------------------------------------------------------


def _factored(p: torch.Tensor) -> bool:
    return p.dim() >= 2


def adafactor_init(cfg: OptimizerConfig, params):
    def per_param(p):
        if _factored(p):
            return {
                "vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),  # row stats
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                  device=p.device),  # column stats
            }
        return {"v": torch.zeros_like(p, dtype=torch.float32)}

    return {"v": tree_map(per_param, params), "count": _count_like(params)}


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, grads, state, params):
    count = state["count"] + 1
    lr = schedule(cfg, count)
    beta2 = 1.0 - count.to(torch.float32) ** (-cfg.decay_rate)

    def upd(g, p, v):
        g32, p32 = g.float(), p.float()
        g2 = torch.square(g32) + 1e-30
        if _factored(p):
            vr = beta2 * v["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * v["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
            row_mean = torch.clamp(torch.mean(vr, dim=-1, keepdim=True)[..., None], min=1e-30)
            denom = torch.sqrt(vr[..., None] * vc[..., None, :] / row_mean)
            new_v = {"vr": vr, "vc": vc}
        else:
            nv = beta2 * v["v"] + (1 - beta2) * g2
            denom = torch.sqrt(nv)
            new_v = {"v": nv}
        update = g32 / torch.clamp(denom, min=1e-30)
        # RMS-clipped update (Adafactor's d=1 clipping)
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-30)
        update = update / torch.clamp(rms, min=1.0)
        new_p = p32 - lr * (update + cfg.weight_decay * p32)
        return new_p.to(p.dtype), new_v

    new_params, v = tree_unzip(tree_map(upd, grads, params, state["v"]), 2)
    return new_params, {"v": v, "count": count}


# ---------------------------------------------------------------------------
# uniform interface
# ---------------------------------------------------------------------------


def init(cfg: OptimizerConfig, params):
    if cfg.name == "adamw":
        return adamw_init(cfg, params)
    if cfg.name == "adafactor":
        return adafactor_init(cfg, params)
    raise KeyError(cfg.name)


@torch.no_grad()
def update(cfg: OptimizerConfig, grads, state, params):
    """(new params, new state, {"grad_norm", "lr"}): clip, then the
    optimizer's step."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    if cfg.name == "adamw":
        new_params, new_state = adamw_update(cfg, grads, state, params)
    elif cfg.name == "adafactor":
        new_params, new_state = adafactor_update(cfg, grads, state, params)
    else:
        raise KeyError(cfg.name)
    return new_params, new_state, {"grad_norm": gnorm, "lr": schedule(cfg, new_state["count"])}


def for_arch(arch_params_bytes: int) -> OptimizerConfig:
    """Heuristic: factored states for very large models."""
    if arch_params_bytes > 50e9:
        return OptimizerConfig(name="adafactor")
    return OptimizerConfig(name="adamw")
