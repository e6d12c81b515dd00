"""Reader and writer of the reference's checkpoint layout
(`repro/train/checkpoint.py`), without JAX or `ml_dtypes`:

    <root>/step_00000123.tmp/   # staged writes
    <root>/step_00000123/       # committed: renamed from .tmp
        manifest.json     # step, leaf paths, dtypes, shapes, shard index
        shard_00000.npz   # leaves by flat index

`save` writes a tree of tensors atomically: leaves go to `.tmp`,
`manifest.json` last, then the directory is renamed, so a crash mid-write
never corrupts the latest committed step. Leaves are grouped into shards
of about `shard_bytes`; a bf16 leaf is stored as its int16 bits with
``bfloat16`` in the manifest. `publish_checkpoint` / `fetch_checkpoint`
move a committed step's files between instances as HiCR DataObjects (the
distributed restore path).

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
import shutil
from typing import Any, List, Optional, Tuple

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
    # (`np.ascontiguousarray` makes a 0-d leaf, a step count, 1-d: reshape back)
    contiguous = np.ascontiguousarray(arr).reshape(arr.shape)
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf loaded as {arr.dtype}")
        return torch.from_numpy(contiguous.view(np.int16)).view(torch.bfloat16)
    if arr.dtype.kind == "V":
        raise ValueError(f"leaf of dtype {dtype} loaded as {arr.dtype}: not readable")
    return torch.from_numpy(contiguous)


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


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in the reference's key-path syntax: a dict
    entry ``['key']``, a list index ``[0]``, joined by "/". None is an empty
    subtree, as in JAX."""
    if isinstance(tree, dict):
        items = [(f"['{k}']", v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    elif tree is None:
        return []
    else:
        return [(prefix, tree)]
    out = []
    for key, v in items:
        out += _flatten_with_paths(v, f"{prefix}/{key}" if prefix else key)
    return out


def _array(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array to store, manifest dtype) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(root: str, step: int, tree: Any, *, extra: Optional[dict] = None,
         shard_bytes: int = 256 << 20) -> str:
    """Atomically save a tree of tensors (dicts, lists, tensors or numpy
    leaves) as step `step` under `root`. Returns the committed path."""
    name = f"step_{step:08d}"
    tmp = os.path.join(root, name + ".tmp")
    final = os.path.join(root, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    flat = _flatten_with_paths(tree)
    arrays, dtypes = zip(*(_array(leaf) for _, leaf in flat)) if flat else ((), ())
    shards, current, current_bytes = [], [], 0
    for i, arr in enumerate(arrays):
        current.append(i)
        current_bytes += arr.nbytes
        if current_bytes >= shard_bytes:
            shards.append(current)
            current, current_bytes = [], 0
    if current:
        shards.append(current)

    shard_index = {}
    for si, idxs in enumerate(shards):
        fname = f"shard_{si:05d}.npz"
        np.savez(os.path.join(tmp, fname), **{str(i): arrays[i] for i in idxs})
        for i in idxs:
            shard_index[str(i)] = fname

    manifest = {
        "step": step,
        "paths": [path for path, _ in flat],
        "dtypes": list(dtypes),
        "shapes": [list(a.shape) for a in arrays],
        "shard_index": shard_index,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # commit point
    return final


def publish_checkpoint(engine, mem, path: str):
    """Publish each file of a committed checkpoint as an HiCR DataObject
    through `engine` (`frontends/dataobject.py::DataObjectEngine`), staged in
    slots of `mem`'s first memory space. Returns {fname: (DataObjectId,
    size)}."""
    ids = {}
    space = mem.memory_spaces()[0]
    for fname in sorted(os.listdir(path)):
        with open(os.path.join(path, fname), "rb") as f:
            blob = f.read()
        slot = mem.allocate_local_memory_slot(space, max(len(blob), 1))
        slot.handle[: len(blob)] = bytearray(blob)
        ids[fname] = (engine.publish(slot), len(blob))
    return ids


def fetch_checkpoint(engine, ids: dict, dst_dir: str) -> str:
    """Restore side: fetch published files into `dst_dir`."""
    os.makedirs(dst_dir, exist_ok=True)
    for fname, (ident, size) in ids.items():
        slot = engine.fetch(ident)
        with open(os.path.join(dst_dir, fname), "wb") as f:
            f.write(bytes(slot.handle[:size]))
    return dst_dir
