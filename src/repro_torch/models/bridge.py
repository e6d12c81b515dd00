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

Optimizer state (`opt_state_from_jax`): AdamW's ``mu`` and ``nu`` mirror
the parameter tree and cross through the same unstacking; Adafactor's
``v`` keeps the reference's layer stacks, the layout the port's Adafactor
steps on (`stack_params` / `unstack_params`, see `train/optimizer.py`). A
reference checkpoint of ``{"params", "opt"}`` then resumes in the port.
"""
from __future__ import annotations

from typing import Any, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.train.tree import tree_map
from .common import resolve_device
from .hybrid import group_structure
from .transformer import has_units, unit_structure

#: leaves kept in fp32 whatever the matrices' storage dtype (rms_norm reads
#: the norm weights as fp32, Mamba2 its decay parameters, the MoE its router)
NORM_KEYS = frozenset({"ln1", "ln2", "ln_x", "final_norm", "enc_norm", "norm", "out_norm",
                       "A_log", "dt_bias", "router"})


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
            layers.append(tree_map(lambda a, i=i: a[i], tree["layers"]))
    else:
        for u in range(n_units):
            for j in range(unit_len):
                layers.append(tree_map(lambda a, u=u, j=j: a[u, j], tree["units"]))
        for t in range(n_tail):
            layers.append(tree_map(lambda a, t=t: a[t], tree["tail"]))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config has {cfg.num_layers}")
    out = {}
    for k, v in tree.items():  # in the tree's order, the stacks as "layers"
        if k in ("layers", "units", "tail"):
            out["layers"] = layers
        else:
            out[k] = dict(v) if k == "embed" else v
    return out


def unstack_encdec(cfg: ArchConfig, tree: Mapping[str, Any]) -> dict:
    """Reference encoder-decoder tree -> the port's: the ``encoder`` and
    ``decoder`` stacks as per-layer lists (views, no copy), the rest as is."""
    out = dict(tree)
    out["encoder"] = [tree_map(lambda a, i=i: a[i], tree["encoder"])
                      for i in range(cfg.encoder_layers)]
    out["decoder"] = [tree_map(lambda a, i=i: a[i], tree["decoder"]) for i in range(cfg.num_layers)]
    return out


def unstack_hybrid(cfg: ArchConfig, tree: Mapping[str, Any]) -> dict:
    """Reference hybrid tree -> the port's: the ``mamba`` and ``mamba_tail``
    stacks as per-layer lists (views, no copy), the rest as is."""
    g, n_groups, n_tail = group_structure(cfg)
    out = dict(tree)
    out["mamba"] = [tree_map(lambda a, i=i: a[i], tree["mamba"]) for i in range(n_groups * g)]
    if n_tail:
        out["mamba_tail"] = [tree_map(lambda a, i=i: a[i], tree["mamba_tail"]) for i in range(n_tail)]
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


def stack_params(cfg: ArchConfig, tree: Mapping[str, Any]) -> dict:
    """The port's tree with its per-layer lists stacked as the reference
    stacks them, by copy: the transformer's (the VLM's too) ``units``
    (n_units, unit_len, ...) and ``tail``, or ``layers`` (num_layers, ...),
    the inverse of `unstack_layers`; the hybrid's ``mamba`` (n_groups *
    interval, ...) and ``mamba_tail`` (n_tail, ...); the encoder-decoder's
    ``encoder`` (encoder_layers, ...) and ``decoder`` (num_layers, ...).
    xlstm's tree (``blocks``) is the reference's already."""
    stack = lambda *leaves: torch.stack(leaves)  # noqa: E731
    if "blocks" in tree:
        return dict(tree)
    if cfg.family == "hybrid":
        out = dict(tree)
        for key in ("mamba", "mamba_tail"):
            if key in tree:
                out[key] = tree_map(stack, *tree[key])
        return out
    if cfg.family == "audio":
        return dict(tree, encoder=tree_map(stack, *tree["encoder"]),
                    decoder=tree_map(stack, *tree["decoder"]))
    layers = tree["layers"]
    if not has_units(cfg):
        stacks = {"layers": tree_map(stack, *layers)}
    else:
        unit_len, n_units, n_tail = unit_structure(cfg)
        units = [tree_map(stack, *layers[u * unit_len:(u + 1) * unit_len])
                 for u in range(n_units)]
        stacks = {"units": tree_map(stack, *units)}
        if n_tail:
            stacks["tail"] = tree_map(stack, *layers[n_units * unit_len:])
    out = {}
    for k, v in tree.items():  # in the tree's order, the stacks where "layers" was
        if k == "layers":
            out.update(stacks)
        else:
            out[k] = v
    return out


def unstack_params(cfg: ArchConfig, tree: Mapping[str, Any]) -> dict:
    """The inverse of `stack_params`: per-layer views of the stacks."""
    if "blocks" in tree:
        return dict(tree)
    if cfg.family == "hybrid":
        return unstack_hybrid(cfg, tree)
    if cfg.family == "audio":
        return unstack_encdec(cfg, tree)
    return unstack_layers(cfg, tree)


def opt_state_from_jax(cfg: ArchConfig, opt: Mapping[str, Any], *, device=None) -> dict:
    """The reference's optimizer state (its `train/optimizer.py::init`
    tree, numpy leaves or the checkpoint reader's tensors) as the port's on
    `device`: AdamW's moments unstacked like the parameters, Adafactor's
    factored statistics in the reference's stacked layout, the step count
    an int32 0-d tensor."""
    device = resolve_device(device)
    count = as_tensor(opt["count"]).to(torch.int32).reshape(()).to(device)
    if "mu" in opt:
        return {"mu": params_from_jax(cfg, opt["mu"], device=device),
                "nu": params_from_jax(cfg, opt["nu"], device=device), "count": count}
    if "v" in opt:
        return {"v": tree_map(lambda a: as_tensor(a).float().to(device), opt["v"]),
                "count": count}
    raise KeyError(f"optimizer state with keys {sorted(opt)}: neither AdamW's nor Adafactor's")
