"""Stateless HiCR components (paper §3.1).

Stateless components represent information about the system or the static
description of a function. They can be copied, replicated, serialized, and
transmitted as required. None of them touch device state.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Mapping, Sequence


# ---------------------------------------------------------------------------
# Topology components (paper §3.1.2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ComputeResource:
    """A hardware or logical element capable of performing computation.

    Contains all information needed to uniquely identify the corresponding
    processor: e.g. a CPU core index, a TPU chip's TensorCore, or a whole
    mesh slice treated as one SPMD computer.
    """

    kind: str  # ComputeResourceKind value
    index: int
    device_id: str
    # Target peak throughput, used by the roofline layer. 0 = unknown.
    peak_flops_bf16: float = 0.0
    attributes: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "index": self.index,
            "device_id": self.device_id,
            "peak_flops_bf16": self.peak_flops_bf16,
            "attributes": dict(self.attributes),
        }

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "ComputeResource":
        return ComputeResource(
            kind=d["kind"],
            index=int(d["index"]),
            device_id=d["device_id"],
            peak_flops_bf16=float(d.get("peak_flops_bf16", 0.0)),
            attributes=dict(d.get("attributes", {})),
        )


@dataclasses.dataclass(frozen=True)
class MemorySpace:
    """An explicitly addressable memory segment of non-zero size.

    Reports the *physical* capacity (paper: "the actual physical size is
    given, and not the size of the virtually addressable space").
    """

    kind: str  # MemorySpaceKind value
    index: int
    device_id: str
    size_bytes: int
    bandwidth_bytes_per_s: float = 0.0
    attributes: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.size_bytes <= 0:
            raise ValueError("MemorySpace must have non-zero physical size")

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "index": self.index,
            "device_id": self.device_id,
            "size_bytes": self.size_bytes,
            "bandwidth_bytes_per_s": self.bandwidth_bytes_per_s,
            "attributes": dict(self.attributes),
        }

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "MemorySpace":
        return MemorySpace(
            kind=d["kind"],
            index=int(d["index"]),
            device_id=d["device_id"],
            size_bytes=int(d["size_bytes"]),
            bandwidth_bytes_per_s=float(d.get("bandwidth_bytes_per_s", 0.0)),
            attributes=dict(d.get("attributes", {})),
        )


@dataclasses.dataclass(frozen=True)
class Device:
    """A single hardware element (e.g. a NUMA domain, a GPU, a TPU chip)
    containing zero or more memory spaces and compute resources."""

    device_id: str
    kind: str
    compute_resources: Sequence[ComputeResource] = ()
    memory_spaces: Sequence[MemorySpace] = ()
    attributes: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def get_compute_resources(self) -> Sequence[ComputeResource]:
        return tuple(self.compute_resources)

    def get_memory_spaces(self) -> Sequence[MemorySpace]:
        return tuple(self.memory_spaces)

    def to_dict(self) -> dict:
        return {
            "device_id": self.device_id,
            "kind": self.kind,
            "compute_resources": [c.to_dict() for c in self.compute_resources],
            "memory_spaces": [m.to_dict() for m in self.memory_spaces],
            "attributes": dict(self.attributes),
        }

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "Device":
        return Device(
            device_id=d["device_id"],
            kind=d["kind"],
            compute_resources=tuple(
                ComputeResource.from_dict(c) for c in d.get("compute_resources", [])
            ),
            memory_spaces=tuple(
                MemorySpace.from_dict(m) for m in d.get("memory_spaces", [])
            ),
            attributes=dict(d.get("attributes", {})),
        )


@dataclasses.dataclass(frozen=True)
class Topology:
    """Full or partial information about an instance's hardware devices.

    Serializable so users can broadcast it and build a topological picture of
    the entire distributed system (paper §3.1.2).
    """

    devices: Sequence[Device] = ()

    def get_devices(self) -> Sequence[Device]:
        return tuple(self.devices)

    def merge(self, other: "Topology") -> "Topology":
        """Combine topologies discovered by different topology managers."""
        seen = {d.device_id for d in self.devices}
        extra = [d for d in other.devices if d.device_id not in seen]
        return Topology(devices=tuple(self.devices) + tuple(extra))

    # -- serialization (stateless components are transmittable) -------------
    def serialize(self) -> bytes:
        return json.dumps({"devices": [d.to_dict() for d in self.devices]}).encode()

    @staticmethod
    def deserialize(blob: bytes) -> "Topology":
        d = json.loads(blob.decode())
        return Topology(devices=tuple(Device.from_dict(x) for x in d["devices"]))

    # -- convenience queries -------------------------------------------------
    def all_compute_resources(self) -> Sequence[ComputeResource]:
        return tuple(c for d in self.devices for c in d.compute_resources)

    def all_memory_spaces(self) -> Sequence[MemorySpace]:
        return tuple(m for d in self.devices for m in d.memory_spaces)

    def total_memory_bytes(self, kind: str | None = None) -> int:
        return sum(
            m.size_bytes
            for m in self.all_memory_spaces()
            if kind is None or m.kind == kind
        )

    def satisfies(self, requirements: "InstanceTemplate") -> bool:
        """Check whether this topology meets an instance template's minimum
        hardware requirements."""
        req = requirements
        if len(self.all_compute_resources()) < req.min_compute_resources:
            return False
        if self.total_memory_bytes() < req.min_memory_bytes:
            return False
        if req.required_device_kinds:
            kinds = {d.kind for d in self.devices}
            if not set(req.required_device_kinds).issubset(kinds):
                return False
        return True


# ---------------------------------------------------------------------------
# Execution unit (paper §3.1.5): the *static* description of a function.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExecutionUnit:
    """Static description of a procedure: inputs -> processing -> output.

    The semantics are given by the user following the format prescribed by
    the compute manager that will run it (`format` tags which managers can
    accept it: e.g. "python-callable", "generator", "jax-jit", "pallas").
    """

    name: str
    format: str
    fn: Callable[..., Any]
    metadata: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def replicate(self) -> "ExecutionUnit":
        """Stateless components may be copied/replicated freely."""
        return ExecutionUnit(self.name, self.format, self.fn, dict(self.metadata))


# ---------------------------------------------------------------------------
# Instance template (paper §3.1.1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InstanceTemplate:
    """Description of the minimal hardware resources required from a new
    instance, plus any custom metadata accepted by the underlying technology."""

    min_compute_resources: int = 1
    min_memory_bytes: int = 0
    required_device_kinds: Sequence[str] = ()
    metadata: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "min_compute_resources": self.min_compute_resources,
            "min_memory_bytes": self.min_memory_bytes,
            "required_device_kinds": list(self.required_device_kinds),
            "metadata": dict(self.metadata),
        }

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "InstanceTemplate":
        return InstanceTemplate(
            min_compute_resources=int(d.get("min_compute_resources", 1)),
            min_memory_bytes=int(d.get("min_memory_bytes", 0)),
            required_device_kinds=tuple(d.get("required_device_kinds", ())),
            metadata=dict(d.get("metadata", {})),
        )
