"""Train-step factory: loss -> backward -> (optional microbatch
accumulation) -> (optional int8 error-feedback compression) -> clip ->
optimizer update. Port of `repro/train/train_step.py`.

The step keeps the reference's functional shape,
``(params, opt_state, ef_state, batch) -> (params, opt_state, ef_state,
metrics)``: the parameters it is given are not changed (autograd runs on
detached aliases of them) and it returns new ones. Parameters are the fp32
masters (`cfg.param_dtype`); each use casts them to the compute dtype, so
the gradients come back in fp32. On the card every attention's gradient is
the flash backward kernel (`kernels/ops.py::attention`).

Microbatching splits the batch's leading dimension into k slices and
averages the loss, the metrics and the fp32 gradients over them, as the
reference does. There is no `mesh` argument: multi-device training is a
later slice.

Two steps are not elementwise: int8 compression scales each leaf by its
largest value, and Adafactor factors and clips each leaf. The reference's
leaves are its layer stacks, so both run on the parameters and gradients
stacked as the reference stacks them (`models/bridge.py::stack_params`),
and the error-feedback residuals and Adafactor's statistics keep that
layout; AdamW, elementwise, steps on the port's per-layer tree.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models import bridge
from repro_torch.models.model_zoo import ModelBundle
from . import optimizer as opt_lib
from .compression import compress_decompress
from .tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    grad_compression: Optional[str] = None  # None | "int8_ef"


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays (the data stream's) as tensors on `device`;
    tensors are moved, other values kept."""
    def leaf(x):
        if isinstance(x, np.ndarray):
            return torch.as_tensor(x, device=device)
        return x.to(device) if isinstance(x, torch.Tensor) else x
    return {k: leaf(v) for k, v in batch.items()}


def compute_grads(model: ModelBundle, params, batch: dict, *, microbatches: int = 1):
    """(loss, metrics, grads): the batch's mean loss and metrics (detached
    0-d tensors) and the fp32 gradient of the loss with respect to every
    parameter, in the parameters' tree. `microbatches` > 1 averages k
    slices of the batch."""
    leaves = tree_leaves(params)
    device = leaves[0].device
    batch = batch_to(batch, device)

    def grad_of(micro):
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, metrics = model.loss(tree_unflatten(params, live), micro)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    k = microbatches
    if k <= 1:
        loss, metrics, grads = grad_of(batch)
        return loss, metrics, tree_unflatten(params, grads)
    for name, x in batch.items():
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] % k:
            raise ValueError(f"batch {name!r} of {x.shape[0]} rows does not split into {k}")
    loss = torch.zeros((), dtype=torch.float32, device=device)
    metrics = {"ce_loss": loss.clone(), "moe_aux": loss.clone()}
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=device) for p in leaves]
    for i in range(k):
        micro = {name: (x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
                        if isinstance(x, torch.Tensor) and x.dim() >= 1 else x)
                 for name, x in batch.items()}
        l_i, m_i, g_i = grad_of(micro)
        loss = loss + l_i
        metrics = {name: metrics[name] + m_i[name] for name in metrics}
        grads = [a + b for a, b in zip(grads, g_i)]
        del g_i
    inv = 1.0 / k
    return (loss * inv, {name: m * inv for name, m in metrics.items()},
            tree_unflatten(params, [g * inv for g in grads]))


def make_train_step(model: ModelBundle, opt_cfg: opt_lib.OptimizerConfig,
                    train_cfg: TrainConfig = TrainConfig(), *,
                    grads_hook: Optional[Callable] = None) -> Callable:
    """Returns train_step(params, opt_state, ef_state, batch) -> (params,
    opt_state, ef_state, metrics). `grads_hook`, if given, sees each step's
    averaged gradient tree before compression and clipping (a check that
    every parameter got one). See the module note for the layouts."""
    stack, unstack = _stacking(model)
    factored = opt_cfg.name == "adafactor"

    def train_step(params, opt_state, ef_state, batch):
        loss, metrics, grads = compute_grads(model, params, batch,
                                             microbatches=train_cfg.microbatches)
        if grads_hook is not None:
            grads_hook(grads)
        if train_cfg.grad_compression == "int8_ef":
            grads, ef_state = compress_decompress(stack(grads), ef_state)
            grads = unstack(grads)
        if factored:
            new_params, new_opt_state, opt_metrics = opt_lib.update(
                opt_cfg, stack(grads), opt_state, stack(params))
            new_params = unstack(new_params)
        else:
            new_params, new_opt_state, opt_metrics = opt_lib.update(
                opt_cfg, grads, opt_state, params)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return new_params, new_opt_state, ef_state, metrics

    return train_step


def _stacking(model: ModelBundle):
    """(stack, unstack) between the port's per-layer tree and the
    reference's layer stacks."""
    cfg = model.cfg
    return (lambda t: bridge.stack_params(cfg, t)), (lambda t: bridge.unstack_params(cfg, t))


def init_train_state(model: ModelBundle, opt_cfg: opt_lib.OptimizerConfig, *, seed: int = 0,
                     device=None, train_cfg: TrainConfig = TrainConfig(), params=None):
    """(params, opt_state, ef_state): seeded fp32 masters on `device` (None:
    the current CUDA device) unless `params` are given, the optimizer's
    zero state, and the error-feedback residuals (zeros, in the reference's
    stacked layout) when the step compresses its gradients."""
    if params is None:
        params = model.init(seed=seed, device=device)
    stack, _ = _stacking(model)
    opt_state = opt_lib.init(opt_cfg, stack(params) if opt_cfg.name == "adafactor" else params)
    ef_state = None
    if train_cfg.grad_compression == "int8_ef":
        ef_state = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                            stack(params))
    return params, opt_state, ef_state
