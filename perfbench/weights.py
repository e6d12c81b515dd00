"""Weights of a dense decoder-only LM, made from the seed on the device in
two calls, in the layout the port's `models/transformer.py` reads.

Every matrix of the model is a view into one flat buffer of normal draws
(one `torch.randn` call, in the type the weights are served or trained in),
scaled in place by 1/sqrt(fan_in) as the port's own initialiser scales them;
the norm weights are a second draw, N(0, 0.1), in fp32 as the port keeps
them (so a norm's (1 + w) scale is not 1 and is exercised). The same seed
gives the same weights on every run; the benchmark hands them to the
program and to the plain reference alike.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

NORM_STD = 0.1


def matrix_shapes(arch) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(path, shape, fan_in) of every matrix, in the flat buffer's order."""
    d, H, KV = arch.d_model, arch.num_heads, arch.num_kv_heads
    hd, f, V = arch.head_dim or d // H, arch.d_ff, arch.vocab_size
    out = [("embed.embedding", (V, d), d)]
    if not arch.tie_embeddings:
        out.append(("embed.unembed", (d, V), d))
    for i in range(arch.num_layers):
        p = f"layers.{i}"
        out += [(f"{p}.attn.wq", (d, H, hd), d), (f"{p}.attn.wk", (d, KV, hd), d),
                (f"{p}.attn.wv", (d, KV, hd), d), (f"{p}.attn.wo", (H, hd, d), H * hd),
                (f"{p}.ffn.w_up", (d, f), d), (f"{p}.ffn.w_down", (f, d), f)]
        if arch.act == "silu":
            out.append((f"{p}.ffn.w_gate", (d, f), d))
    return out


def norm_paths(arch) -> List[str]:
    return [f"layers.{i}.{n}" for i in range(arch.num_layers) for n in ("ln1", "ln2")] + \
        ["final_norm"]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2**63 - 1))
    return g


def make_flat(arch, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """Path -> tensor of every weight, the matrices as views into one buffer."""
    shapes = matrix_shapes(arch)
    total = sum(_numel(s) for _, s, _ in shapes)
    buf = torch.randn(total, generator=_generator(seed, 0, device), device=device, dtype=dtype)
    flat, off = {}, 0
    for path, shape, fan_in in shapes:
        n = _numel(shape)
        view = buf[off:off + n].view(shape)
        view.mul_(fan_in ** -0.5)
        flat[path] = view
        off += n
    paths = norm_paths(arch)
    norms = torch.randn(len(paths) * arch.d_model, generator=_generator(seed, 1, device),
                        device=device, dtype=torch.float32).mul_(NORM_STD)
    for j, path in enumerate(paths):
        flat[path] = norms[j * arch.d_model:(j + 1) * arch.d_model]
    return flat


def to_tree(flat: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree: {"embed", "final_norm", "layers": [...]}."""
    tree: dict = {"layers": []}
    for path, t in flat.items():
        parts = path.split(".")
        if parts[0] == "layers":
            i = int(parts[1])
            while len(tree["layers"]) <= i:
                tree["layers"].append({})
            node = tree["layers"][i]
            parts = parts[2:]
        else:
            node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = t
    return tree


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Path -> tensor of a parameter tree (the inverse of `to_tree`)."""
    out = {}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out
