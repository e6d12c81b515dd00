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
reference does.

With a `mesh` (a `DeviceMesh` with named dims) the step is one SPMD program
over DTensors: the parameters are placed by `param_shardings(
default_plan(cfg))`, the optimizer state by `opt_state_shardings`
(`shard_train_state`), and each microbatch slice of the global batch by
`input_shardings` (the reference's `_constrain_micro`). The model runs
under `ambient.active_mesh` and DTensor's implicit replication (plain
tensors made inside it, positions and masks, act as replicated); the
kernels see local shards (`kernels/sharded.py`). Gradient averaging over
the data axes comes from the loss being a mean over the global batch: each
gradient arrives as a partial sum and is redistributed to its parameter's
placements, which is the reduction. No explicit all-reduce is added.

Two steps are not elementwise: int8 compression scales each leaf by its
largest value, and Adafactor factors and clips each leaf. The reference's
leaves are its layer stacks, so both run on the parameters and gradients
stacked as the reference stacks them (`models/bridge.py::stack_params`),
and the error-feedback residuals and Adafactor's statistics keep that
layout; AdamW, elementwise, steps on the port's per-layer tree.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models import bridge
from repro_torch.models.model_zoo import ModelBundle, logical_axes
from repro_torch.sharding import partition
from repro_torch.sharding.ambient import active_mesh
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


@contextlib.contextmanager
def _mesh_scope(mesh):
    """The context a mesh step runs in: the ambient mesh, and DTensor's
    implicit replication of plain tensors. Nothing without a mesh."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with active_mesh(mesh), implicit_replication():
        yield


def compute_grads(model: ModelBundle, params, batch: dict, *, microbatches: int = 1,
                  mesh=None):
    """(loss, metrics, grads): the batch's mean loss and metrics (detached
    0-d tensors) and the fp32 gradient of the loss with respect to every
    parameter, in the parameters' tree. `microbatches` > 1 averages k
    slices of the batch. With a `mesh` the parameters are DTensors, each
    slice is placed by `input_shardings` and each gradient comes back in its
    parameter's placements."""
    leaves = tree_leaves(params)
    device = leaves[0].device
    batch = batch_to(batch, device)

    def place(micro):
        if mesh is None:
            return micro
        specs = partition.input_shardings(micro, mesh, model.cfg, None)
        return partition.distribute(micro, specs, mesh)

    def grad_of(micro):
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad(), _mesh_scope(mesh):
            loss, metrics = model.loss(tree_unflatten(params, live), place(micro))
            grads = torch.autograd.grad(loss, live, allow_unused=True)
            grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else _like(g.float(), p)
                     for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    k = microbatches
    if k <= 1:
        loss, metrics, grads = grad_of(batch)
        return loss, metrics, tree_unflatten(params, grads)
    for name, x in batch.items():
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] % k:
            raise ValueError(f"batch {name!r} of {x.shape[0]} rows does not split into {k}")
    loss = metrics = grads = None
    for i in range(k):
        micro = {name: (x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
                        if isinstance(x, torch.Tensor) and x.dim() >= 1 else x)
                 for name, x in batch.items()}
        l_i, m_i, g_i = grad_of(micro)
        if grads is None:
            loss, metrics, grads = l_i, m_i, g_i
            continue
        with _mesh_scope(mesh):
            loss = loss + l_i
            metrics = {name: metrics[name] + m_i[name] for name in metrics}
            grads = [a + b for a, b in zip(grads, g_i)]
        del g_i
    inv = 1.0 / k
    return (loss * inv, {name: m * inv for name, m in metrics.items()},
            tree_unflatten(params, [g * inv for g in grads]))


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient (a partial sum over the data axes, most often) in
    its parameter's placements: the cross-replica reduction."""
    if hasattr(g, "placements") and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model: ModelBundle, opt_cfg: opt_lib.OptimizerConfig,
                    train_cfg: TrainConfig = TrainConfig(), *, mesh=None,
                    grads_hook: Optional[Callable] = None) -> Callable:
    """Returns train_step(params, opt_state, ef_state, batch) -> (params,
    opt_state, ef_state, metrics). `grads_hook`, if given, sees each step's
    averaged gradient tree before compression and clipping (a check that
    every parameter got one). `mesh`: the step runs over DTensors placed by
    `shard_train_state`; its metrics come back as plain tensors. See the
    module note for the layouts."""
    stack, unstack = _stacking(model)
    factored = opt_cfg.name == "adafactor"

    def train_step(params, opt_state, ef_state, batch):
        loss, metrics, grads = compute_grads(model, params, batch,
                                             microbatches=train_cfg.microbatches, mesh=mesh)
        if grads_hook is not None:
            grads_hook(grads)
        with _mesh_scope(mesh):
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
            if mesh is not None:
                metrics = {k: _plain(v) for k, v in metrics.items()}
        return new_params, new_opt_state, ef_state, metrics

    return train_step


def _plain(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def shard_train_state(model: ModelBundle, mesh, params, opt_state=None, ef_state=None):
    """(params, opt_state, ef_state) placed on `mesh` as DTensors: the
    parameters by `param_shardings(logical_axes, default_plan(cfg))`, the
    optimizer state by `opt_state_shardings` (in the layout the optimizer
    keeps it: Adafactor's stacked), the error-feedback residuals like the
    stacked parameters. None stays None."""
    cfg = model.cfg
    plan = partition.default_plan(cfg)
    p_specs = partition.param_shardings(logical_axes(cfg, params), params, mesh, plan)
    out = [partition.distribute(params, p_specs, mesh)]
    stack, _ = _stacking(model)
    stacked = stack(params)
    s_specs = partition.param_shardings(stacked_axes(cfg, params), stacked, mesh, plan)
    for state, (ref_tree, ref_specs) in ((opt_state, (params, p_specs)),
                                         (ef_state, (stacked, s_specs))):
        if state is None:
            out.append(None)
            continue
        if "v" in state:  # Adafactor: its statistics follow the stacked parameters
            ref_tree, ref_specs = stacked, s_specs
        specs = partition.opt_state_shardings(state, ref_tree, ref_specs, mesh)
        out.append(partition.distribute(state, specs, mesh))
    return tuple(out)


def stacked_axes(cfg, params):
    """The logical axes of `bridge.stack_params(cfg, params)`: the
    per-layer axes behind an unsharded "layers" axis a stack dim, as the
    reference's trees carry them."""
    return logical_axes(cfg, bridge.stack_params(cfg, params), stacked=True)


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
