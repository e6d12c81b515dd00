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

Hybrid (zamba2) trees stack their Mamba2 layers: ``mamba`` leaves are
(n_groups * interval, ...) and ``mamba_tail`` leaves (n_tail, ...); the
port keeps one dict per layer in each list, and the shared block as is.

MoE layers carry ``moe`` (``router`` (d, E), ``w_up``/``w_gate`` (E, d, f),
``w_down`` (E, f, d)) in place of ``ffn``; the router stays fp32. The VLM's
tree is the transformer's plus ``vision_proj``; the encoder-decoder's
(``embed``, ``enc_pos``, ``encoder`` stacked over ``encoder_layers``,
``enc_norm``, ``decoder`` stacked over ``num_layers`` with ``ln_x`` and
``cross``, ``final_norm``) becomes per-layer ``encoder`` and ``decoder``
lists.

Leaves may also be CPU tensors (the checkpoint reader's); bf16 crosses bit
for bit (`as_tensor`).
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from .common import resolve_device
from .hybrid import group_structure
from .transformer import unit_structure

#: leaves kept in fp32 whatever the matrices' storage dtype (rms_norm reads
#: the norm weights as fp32, Mamba2 its decay parameters, the MoE its router)
NORM_KEYS = frozenset({"ln1", "ln2", "ln_x", "final_norm", "enc_norm", "norm", "out_norm",
                       "A_log", "dt_bias", "router"})


def _map(fn: Callable, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def as_tensor(a) -> torch.Tensor:
    """A CPU tensor copy of a leaf: a tensor (the checkpoint reader's) or a
    numpy array. Numpy has no bf16 of its own: JAX's arrays come out as
    `ml_dtypes.bfloat16` and `np.load` gives such leaves back as 2-byte
    void; both are viewed bit for bit as int16 and then as bf16."""
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    a = np.asarray(a)
    if a.dtype.kind == "V":
        if a.dtype.itemsize != 2:
            raise ValueError(f"leaf of dtype {a.dtype}: only 2-byte (bfloat16) void is read")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def unstack_layers(cfg: ArchConfig, tree: Mapping[str, Any]) -> dict:
    """Reference tree -> {"embed", "final_norm", "layers": [per-layer tree]}
    (and any other top-level leaf, the VLM's ``vision_proj``), leaves
    indexed out of the stacks (numpy views, no copy)."""
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
    out = {k: v for k, v in tree.items() if k not in ("layers", "units", "tail")}
    out["embed"] = dict(tree["embed"])
    out["layers"] = layers
    return out


def unstack_encdec(cfg: ArchConfig, tree: Mapping[str, Any]) -> dict:
    """Reference encoder-decoder tree -> the port's: the ``encoder`` and
    ``decoder`` stacks as per-layer lists (views, no copy), the rest as is."""
    out = dict(tree)
    out["encoder"] = [_map(lambda a, i=i: a[i], tree["encoder"])
                      for i in range(cfg.encoder_layers)]
    out["decoder"] = [_map(lambda a, i=i: a[i], tree["decoder"]) for i in range(cfg.num_layers)]
    return out


def unstack_hybrid(cfg: ArchConfig, tree: Mapping[str, Any]) -> dict:
    """Reference hybrid tree -> the port's: the ``mamba`` and ``mamba_tail``
    stacks as per-layer lists (views, no copy), the rest as is."""
    g, n_groups, n_tail = group_structure(cfg)
    out = {k: v for k, v in tree.items() if k not in ("mamba", "mamba_tail")}
    out["mamba"] = [_map(lambda a, i=i: a[i], tree["mamba"]) for i in range(n_groups * g)]
    if n_tail:
        out["mamba_tail"] = [_map(lambda a, i=i: a[i], tree["mamba_tail"]) for i in range(n_tail)]
    return out


def params_from_jax(cfg: ArchConfig, tree: Mapping[str, Any], *, device=None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The reference's `init_lm` params (nested dicts of numpy arrays) as the
    port's params on `device` (None: the current CUDA device, raising where
    there is none; pass ``device="cpu"`` for the CPU). `dtype` stores the
    matrices in another dtype (norm weights stay fp32)."""
    device = resolve_device(device)
    if "blocks" in tree:
        flat = dict(tree)
    elif cfg.family == "hybrid":
        flat = unstack_hybrid(cfg, tree)
    elif cfg.family == "audio":
        flat = unstack_encdec(cfg, tree)
    else:
        flat = unstack_layers(cfg, tree)

    def convert(path_key: str):
        def fn(a):
            t = as_tensor(a)
            if path_key in NORM_KEYS:
                t = t.float()
            elif dtype is not None:
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
