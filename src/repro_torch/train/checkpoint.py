"""Reader of the reference's checkpoint layout (`repro/train/checkpoint.py`),
without JAX or `ml_dtypes`:

    <root>/step_00000123/
        manifest.json     # step, leaf paths, dtypes, shapes, shard index
        shard_00000.npz   # leaves by flat index

A committed step is a directory without the ``.tmp`` suffix that holds a
manifest (`latest_step`). Leaf paths are JAX key paths joined by "/", e.g.
``['params']/['layers']/[0]/['attn']/['wq']``: a quoted key is a dict
entry, a bare integer a list index. `restore` rebuilds the nested dict/list
tree from them, with each leaf a CPU tensor: fp32 as saved, and bf16 leaves
(which `np.load` returns as 2-byte void, ``|V2``, with ``bfloat16`` in the
manifest) viewed as int16 and then as ``torch.bfloat16``, bit for bit. The
tree feeds `models/bridge.py::params_from_jax`.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

_KEY = re.compile(r"^\['(.*)'\]$")
_INDEX = re.compile(r"^\[(\d+)\]$")


def latest_step(root: str) -> Optional[int]:
    """The newest committed step under `root`, or None."""
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(root, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _leaf(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf loaded as {arr.dtype}")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    if arr.dtype.kind == "V":
        raise ValueError(f"leaf of dtype {dtype} loaded as {arr.dtype}: not readable")
    return torch.from_numpy(np.ascontiguousarray(arr))


def _keys(path: str) -> list:
    out = []
    for part in path.split("/"):
        if (m := _KEY.match(part)) is not None:
            out.append(m.group(1))
        elif (m := _INDEX.match(part)) is not None:
            out.append(int(m.group(1)))
        else:
            raise ValueError(f"checkpoint path {path!r}: cannot read component {part!r}")
    return out


def _lists(node):
    """Dicts keyed 0..n-1 by integers (list indices) become lists."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"list indices {sorted(node)} are not 0..{len(node) - 1}")
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def restore(root: str, *, step: Optional[int] = None) -> Tuple[Any, dict]:
    """Read the checkpoint of `step` (default: the latest committed one)
    under `root`. Returns (tree of CPU tensors, the manifest's `extra`)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    path = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    shards: dict = {}
    tree: dict = {}
    for i, (leaf_path, dtype, shape) in enumerate(
            zip(manifest["paths"], manifest["dtypes"], manifest["shapes"])):
        fname = manifest["shard_index"][str(i)]
        if fname not in shards:
            shards[fname] = np.load(os.path.join(path, fname))
        t = _leaf(shards[fname][str(i)], dtype)
        if list(t.shape) != list(shape):
            raise ValueError(f"{leaf_path}: shape {list(t.shape)}, manifest says {shape}")
        *parents, last = _keys(leaf_path)
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = t
    return _lists(tree), manifest["extra"]
