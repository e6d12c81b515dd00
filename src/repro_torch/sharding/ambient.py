"""Ambient-mesh sharding constraints for model-internal code. Port of
`repro/sharding/ambient.py`.

Model functions are mesh-agnostic; distribution flows in through the
DTensor placements of their inputs. For a few data-dependent ops (the MoE
sort-based dispatch) the placements DTensor would propagate replicate large
gather/scatter intermediates, or it has no rule at all; the launcher
publishes the active mesh here and `constrain` then pins those
intermediates. When no mesh is active, or the tensor is not a DTensor (CPU
tests, single-device runs), it is a no-op.
"""
from __future__ import annotations

import contextlib

import torch

_ACTIVE = None


@contextlib.contextmanager
def active_mesh(mesh):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def get_active_mesh():
    return _ACTIVE


def constrain(x: torch.Tensor, *parts) -> torch.Tensor:
    """`x` redistributed to the spec ``P(*parts)`` against the ambient mesh
    (the reference's `with_sharding_constraint`); axes not present in the
    mesh are dropped; no-op without a mesh, for a plain tensor, or when a
    dimension does not divide. Differentiable (`DTensor.redistribute`)."""
    mesh = _ACTIVE
    if mesh is None or not _is_dtensor(x):
        return x
    from .partition import P, mesh_shape, placements

    names = mesh_shape(mesh)
    clean = []
    for dim, part in zip(x.shape, parts):
        axes = part if isinstance(part, tuple) else ((part,) if part else ())
        axes = tuple(a for a in axes if a in names)
        size = 1
        for a in axes:
            size *= names[a]
        if not axes or dim % size != 0:
            clean.append(None)
        elif len(axes) == 1:
            clean.append(axes[0])
        else:
            clean.append(axes)
    clean += [None] * (x.ndim - len(clean))
    return x.redistribute(x.device_mesh, placements(P(*clean), x.device_mesh))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)
