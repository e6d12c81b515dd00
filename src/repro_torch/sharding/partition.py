"""Logical-axis partitioning: maps the model zoo's logical parameter axes
onto mesh axes with automatic divisibility fallback (replicate when an axis
does not divide), plus input/state sharding heuristics per shape kind. Port
of `repro/sharding/partition.py`.

Parallelism vocabulary:
* DP   — batch over ("pod", "data")
* FSDP — parameter "embed"/"ssm_inner" dims additionally over "data"
         (ZeRO-3-style; optimizer state follows parameters)
* TP   — "heads"/"kv_heads"/"mlp"/"vocab" over "model" (Megatron split)
* EP   — "expert" over "model"
* SP   — long-context decode KV/sequence over "data" when the batch is
         unshardable (long_500k)

The spec logic reads only ``mesh.shape`` (a mapping of axis name to size),
so it runs on a duck-typed mesh as on a `DeviceMesh` (`mesh_shape`). A spec
is a `PartitionSpec`: one entry per tensor dim, None (replicated), a mesh
axis name, or a tuple of names (one dim over several mesh axes). Where the
reference wraps a spec in a `NamedSharding`, the port keeps the spec itself;
`placements` turns it into DTensor placements over a `DeviceMesh`, and
`distribute` places a tree of tensors by a tree of specs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.train.tree import tree_leaves, tree_map


class PartitionSpec(tuple):
    """One entry per tensor dim: None, a mesh axis name, or a tuple of them.
    A tuple, so it compares one for one with the reference's."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _map(fn, tree, *rest):
    """`fn` over the tensors of `tree` (dicts, lists and tuples of them, a
    decode state's (k, v) pairs too), with the matching nodes of `rest`
    walked as deep as `tree`; the result has `tree`'s structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def mesh_shape(mesh) -> Mapping[str, int]:
    """{axis name: size}: a duck mesh's ``shape``, or a `DeviceMesh`'s."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return mesh.shape


@dataclasses.dataclass(frozen=True)
class Plan:
    """Per-arch parallelism plan: logical axis -> mesh axes."""

    rules: Dict[str, Tuple[str, ...]]
    fsdp: bool = False

    def axes_for(self, logical: str) -> Tuple[str, ...]:
        return self.rules.get(logical, ())


def default_plan(cfg: ArchConfig, *, fsdp: Optional[bool] = None) -> Plan:
    if fsdp is None:
        # rough param-count proxy: FSDP for >= ~2B dense / any MoE giant
        approx = cfg.num_layers * cfg.d_model * cfg.d_model * 12
        if cfg.is_moe:
            approx = cfg.num_layers * cfg.num_experts * cfg.d_model * cfg.expert_d_ff * 3
        fsdp = approx > 2e9
    rules = {
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "ssm_inner": ("model",),
        "expert": ("model",),
        "embed": ("data",) if fsdp else (),
        # never sharded: layers/units/norm/head_dim/conv
    }
    return Plan(rules=rules, fsdp=fsdp)


def _mesh_size(mesh, axes: Tuple[str, ...]) -> int:
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in axes])) if axes else 1


def spec_for_leaf(axes: Tuple[str, ...], shape: Tuple[int, ...], mesh, plan: Plan) -> P:
    """Build a PartitionSpec for one parameter leaf, enforcing divisibility
    and single-use of each mesh axis."""
    names = mesh_shape(mesh)
    used: set[str] = set()
    parts = []
    for dim, logical in zip(shape, axes):
        mesh_axes = tuple(a for a in plan.axes_for(logical) if a in names and a not in used)
        if mesh_axes and dim % _mesh_size(mesh, mesh_axes) == 0:
            parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
            used.update(mesh_axes)
        else:
            parts.append(None)
    return P(*parts)


def param_shardings(axes_tree, shape_tree, mesh, plan: Plan):
    """axes_tree: logical-axes tuples per leaf (same structure as params);
    shape_tree: params (meta tensors too). Returns a PartitionSpec tree."""
    return tree_map(lambda leaf, axes: spec_for_leaf(axes, tuple(leaf.shape), mesh, plan),
                    shape_tree, axes_tree)


def dp_axes(mesh) -> Tuple[str, ...]:
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_spec(mesh, batch_size: int) -> P:
    """Shard the batch dim over as many DP axes as divide it."""
    axes = dp_axes(mesh)
    while axes and batch_size % _mesh_size(mesh, axes) != 0:
        axes = axes[1:]  # drop the outermost (pod) axis first
    return P(axes if len(axes) > 1 else (axes[0] if axes else None))


def input_shardings(batch_specs: dict, mesh, cfg: ArchConfig, shape: ShapeConfig):
    """PartitionSpecs for a train/prefill/decode batch dict (tensors or
    meta tensors; 0-d leaves replicated)."""
    out = {}
    for name, sds in batch_specs.items():
        if sds.ndim == 0:
            out[name] = P()
            continue
        bspec = batch_spec(mesh, sds.shape[0])
        parts = [bspec[0]] + [None] * (sds.ndim - 1)
        out[name] = P(*parts)
    return out


def state_shardings(state_specs, mesh, cfg: ArchConfig, shape: ShapeConfig):
    """Decode/serve state sharding heuristics.

    Per leaf (KV caches, recurrent states), greedily assign:
      1. the batch dim (== global_batch) to the DP axes,
      2. a heads-like dim (== num_heads or num_kv_heads) to "model",
      3. if batch was unshardable, the sequence dim (>= 4096) to "data" (SP).
    All subject to divisibility; everything else replicated.
    """
    B = shape.global_batch
    H, KV = cfg.num_heads, cfg.num_kv_heads
    names = mesh_shape(mesh)
    data_sz = names.get("data", 1)
    model_sz = names.get("model", 1)
    dpx = dp_axes(mesh)
    dp_sz = _mesh_size(mesh, dpx)

    def leaf_spec(sds):
        parts: list = [None] * sds.ndim
        used_batch = False
        used_model = False
        # 1. batch dim
        for i, d in enumerate(sds.shape):
            if d == B and d % dp_sz == 0 and dp_sz > 1:
                parts[i] = dpx if len(dpx) > 1 else dpx[0]
                used_batch = True
                break
        # 2. heads dim — POSITIONAL: KV caches are (..., S, KV, hd), so the
        #    heads dim is ndim-2 (a value-based search misfires when another
        #    dim happens to equal num_heads).
        hi = sds.ndim - 2
        if (sds.ndim >= 3 and parts[hi] is None and sds.shape[hi] in (H, KV)
                and sds.shape[hi] % model_sz == 0 and model_sz > 1):
            parts[hi] = "model"
            used_model = True
        # 2b. heads that do NOT divide the model axis (GQA kv=8 on model=16)
        #     would force full cache replication: shard the SEQUENCE dim
        #     (ndim-3) over "model" instead.
        si = sds.ndim - 3
        if (not used_model and model_sz > 1 and sds.ndim >= 3 and parts[si] is None
                and sds.shape[si] >= 4096 and sds.shape[si] % model_sz == 0):
            parts[si] = "model"
            used_model = True
        # 3. sequence parallel fallback for unshardable batch
        if not used_batch and data_sz > 1:
            for i, d in enumerate(sds.shape):
                if parts[i] is None and d >= 4096 and d % data_sz == 0:
                    parts[i] = "data"
                    break
        return P(*parts)

    return _map(leaf_spec, state_specs)


def opt_state_shardings(opt_specs, params_specs, param_shardings_tree, mesh):
    """Optimizer state follows parameter sharding (ZeRO): exact-shape leaves
    reuse the param spec; Adafactor's factored stats drop the reduced dim.
    Non-tensor leaves (Adafactor's None for unfactored leaves) stay as
    they are."""
    by_shape: Dict[Tuple, list] = {}
    for leaf, spec in zip(tree_leaves(params_specs), tree_leaves(param_shardings_tree)):
        by_shape.setdefault(tuple(leaf.shape), []).append(spec)

    def match(sds):
        if not isinstance(sds, torch.Tensor):
            return sds
        shape = tuple(sds.shape)
        if shape in by_shape:
            return by_shape[shape][0]
        # factored stats: param shape minus last / minus second-to-last dim
        for pshape, specs in by_shape.items():
            spec = specs[0]
            padded = tuple(spec) + (None,) * (len(pshape) - len(spec))
            if len(pshape) >= 2 and shape == pshape[:-1]:
                return P(*padded[:-1])
            if len(pshape) >= 2 and shape == pshape[:-2] + pshape[-1:]:
                return P(*(padded[:-2] + padded[-1:]))
        return P()  # scalars / counts

    return tree_map(match, opt_specs)


# ---------------------------------------------------------------------------
# DTensor placement
# ---------------------------------------------------------------------------


def placements(spec, mesh) -> tuple:
    """The DTensor placements of `spec` on `mesh` (a `DeviceMesh` with named
    dims): one per mesh dim, ``Shard(d)`` where tensor dim d is split over
    that mesh axis, else ``Replicate()``. One tensor dim over two mesh axes
    (("pod", "data")) is ``Shard(d)`` on both mesh dims, the outer first.
    A mesh axis of size 1 holds the whole tensor either way and is
    ``Replicate()``: DTensor refuses views across a dim it thinks split."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for d, part in enumerate(spec):
        for axis in (part if isinstance(part, tuple) else ((part,) if part else ())):
            i = names.index(axis)
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


def distribute(tree, specs, mesh):
    """Place every tensor of `tree` on `mesh` as a DTensor by the matching
    spec of `specs` (the reference's `with_shardings`). A tensor on the
    ``meta`` device becomes a meta DTensor of the same global shape (a dry
    run's abstract input); a DTensor already placed is redistributed.
    Non-tensor leaves pass through."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(x, spec):
        if not isinstance(x, torch.Tensor):
            return x
        pl = placements(spec, mesh)
        if isinstance(x, DTensor):
            return x.redistribute(mesh, pl)
        if x.device.type == "meta":
            return _meta_dtensor(x, mesh, pl)
        return distribute_tensor(x.to(mesh.device_type) if x.device.type != mesh.device_type
                                 else x, mesh, pl)

    return _map(place, tree, specs)


def _meta_dtensor(x: torch.Tensor, mesh, pl) -> torch.Tensor:
    """A DTensor over `mesh` whose local shard is a meta tensor of this
    rank's shard shape (no allocation, no communication)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local_shape, _ = compute_local_shape_and_global_offset(tuple(x.shape), mesh, pl)
    local = torch.empty(local_shape, dtype=x.dtype, device="meta")
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=x.shape,
                              stride=x.stride())
