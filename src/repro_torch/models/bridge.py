"""Weight bridge: the reference's parameter tree -> the port's parameters.

Transformer trees: the reference's `init_lm` returns nested dicts whose
leaves carry leading stack dims for `jax.lax.scan`: ``units`` leaves are
(n_units, unit_len, ...) and ``tail`` leaves (n_tail, ...) on sliding-window
archs, ``layers`` leaves (num_layers, ...) otherwise. The port keeps one dict per layer, in
layer order: unit u, layer j becomes layer ``unit_len * u + j``; tail layer
t becomes layer ``unit_len * n_units + t``. Weight shapes are unchanged
(e.g. wq (d, H, hd), wo (H, hd, d)). Leaves cross as numpy arrays; nothing
here imports JAX.

xlstm trees (``{"embed", "blocks": [per-block dict], "final_norm"}``) have
no layer stacks: the port keeps the same tree.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from .common import resolve_device
from .transformer import unit_structure

#: leaves kept in fp32 whatever the matrices' storage dtype (rms_norm reads
#: them as fp32)
NORM_KEYS = frozenset({"ln1", "ln2", "final_norm", "norm"})


def _map(fn: Callable, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack_layers(cfg: ArchConfig, tree: Mapping[str, Any]) -> dict:
    """Reference tree -> {"embed", "final_norm", "layers": [per-layer tree]},
    leaves indexed out of the stacks (numpy views, no copy)."""
    unit_len, n_units, n_tail = unit_structure(cfg)
    layers: List[dict] = []
    if "layers" in tree:
        for i in range(cfg.num_layers):
            layers.append(_map(lambda a, i=i: a[i], tree["layers"]))
    else:
        for u in range(n_units):
            for j in range(unit_len):
                layers.append(_map(lambda a, u=u, j=j: a[u, j], tree["units"]))
        for t in range(n_tail):
            layers.append(_map(lambda a, t=t: a[t], tree["tail"]))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config has {cfg.num_layers}")
    return {"embed": dict(tree["embed"]), "final_norm": tree["final_norm"], "layers": layers}


def params_from_jax(cfg: ArchConfig, tree: Mapping[str, Any], *, device=None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The reference's `init_lm` params (nested dicts of numpy arrays) as the
    port's params on `device` (None: the current CUDA device, raising where
    there is none; pass ``device="cpu"`` for the CPU). `dtype` stores the
    matrices in another dtype (norm weights stay fp32)."""
    device = resolve_device(device)
    flat = dict(tree) if "blocks" in tree else unstack_layers(cfg, tree)

    def convert(path_key: str):
        def fn(a):
            t = torch.from_numpy(np.array(a))  # a writable copy
            if dtype is not None and path_key not in NORM_KEYS:
                t = t.to(dtype)
            return t.to(device)
        return fn

    def walk(node, key=""):
        if isinstance(node, Mapping):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        return convert(key)(node)

    return walk(flat)
