"""Roofline terms of a dry run. Port of `repro/launch/roofline.py`.

    compute term    = FLOPs / (chips × peak_FLOP/s)
    memory term     = bytes / (chips × HBM_bw)
    collective term = collective_bytes / (chips × link_bw)

The reference reads FLOPs and bytes from XLA's `cost_analysis()` of the
compiled per-device module and parses collectives out of the optimised HLO
text. The port has no compiler in the loop: the dry run executes the cell
eagerly on meta tensors under a fake process group, and `Counters` records
it as it runs. FLOPs come from `torch.utils.flop_counter.FlopCounterMode`
(on the local shards, so per device), bytes from every aten op's operands
and results, and collective bytes from the output of every
`_c10d_functional` collective DTensor issues, the reference's convention
(the output operand's size).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.backends.gpu_spec import H100, ChipSpec

#: the reference's per-kind keys (HLO op names)
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

#: `_c10d_functional` ops by the HLO kind they stand for
_C10D_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

#: ops that move no data of their own (views and metadata)
_FREE = frozenset({"view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
                   "squeeze", "unsqueeze", "slice", "select", "as_strided", "alias", "detach",
                   "split", "split_with_sizes", "unbind", "chunk", "narrow", "view_as",
                   "_reshape_alias", "lift_fresh", "empty", "empty_like", "empty_strided",
                   "wait_tensor", "unflatten", "flatten", "diagonal", "movedim"})


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def collective_bytes(ops: Iterable[Tuple[str, int]]) -> Dict[str, float]:
    """Per-collective-kind bytes of a recorded op list: (op name, output
    bytes) pairs, the `_c10d_functional` ops among them counted by the HLO
    kind they stand for. Returns {kind: bytes, ..., "total": float}."""
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    for name, nbytes in ops:
        kind = _C10D_KINDS.get(name)
        if kind is not None:
            out[kind] += nbytes
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


class Counters(TorchDispatchMode):
    """A context that counts what runs inside it on this rank's local
    tensors: FLOPs (by `torch.utils.flop_counter.FlopCounterMode`'s
    formulas), bytes and collective bytes. An op on DTensors is left to
    DTensor (the mode declines it, and does not count the fake tensors of
    DTensor's shape propagation), whose local ops and collectives then
    come back here, so every count is per device. Bytes are the operand and
    result bytes of every aten op that is not a view: an unfused upper
    bound, as if every op read its inputs from and wrote its outputs to
    device memory. Read with `.flops`, `.bytes`, `.collectives()`."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self._flop_counter = FlopCounterMode(display=False)
        self.bytes = 0
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        # DTensor's ops are left to DTensor; the fake-tensor runs of its
        # shape propagation pass uncounted; only plain local tensors count
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if any(t is not torch.Tensor for t in types):
            return out
        name = func.overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            self.ops.append((name, sum(_nbytes(x) for x in tree_flatten(out)[0])))
        elif func.namespace == "aten" and name not in _FREE:
            self.bytes += (sum(_nbytes(x) for x in tree_flatten((args, kwargs))[0])
                           + sum(_nbytes(x) for x in tree_flatten(out)[0]))
            self._flop_counter._count_flops(func.overloadpacket, out, args, kwargs)
        return out

    @property
    def flops(self) -> int:
        return int(self._flop_counter.get_total_flops())

    def collectives(self) -> Dict[str, float]:
        return collective_bytes(self.ops)


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    chip: ChipSpec = H100

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.chip.peak_flops_bf16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.chip.hbm_bandwidth

    @property
    def collective_s(self) -> float:
        # formula prescribed: collective_bytes / (chips × link_bw); with
        # per-device bytes this is bytes / link_bw
        return self.collective_bytes_per_device / self.chip.ici_bandwidth_per_link

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "chips": self.chips,
        }


def analyze(counts: Counters, *, chips: int, chip: ChipSpec = H100) -> Roofline:
    """The roofline of what `counts` recorded on one rank (per device)."""
    return Roofline(
        flops_per_device=float(counts.flops),
        bytes_per_device=float(counts.bytes),
        collective_bytes_per_device=float(counts.collectives()["total"]),
        chips=chips,
        chip=chip,
    )


def model_flops(cfg, shape, *, n_params: int, n_active_params: Optional[int] = None) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for train; decode
    and prefill use 2·N·D (forward only)."""
    D = shape.global_batch * shape.seq_len if shape.kind != "decode" else shape.global_batch
    N = n_active_params if (cfg.is_moe and n_active_params) else n_params
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * N * D
