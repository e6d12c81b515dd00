"""Mesh construction. Port of `repro/launch/mesh.py`.

`make_production_mesh` builds the target meshes; `mesh_from_topology`
builds a mesh from a discovered or declared HiCR Topology — the launcher
path: TopologyManagers discover, the mesh builder consumes the Topology,
never the raw device list. A mesh is a `DeviceMesh` with named dims over
the default process group, so its size must be the world size (NCCL on the
card, gloo across CPU processes, the ``fake`` group for a dry run).
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core.stateless import Topology

#: the reference's 256 and 512 devices, `model` = 8 within an 8-GPU node
PRODUCTION_SHAPES = {False: ((32, 8), ("data", "model")),
                     True: ((2, 32, 8), ("pod", "data", "model"))}


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, device_type: Optional[str] = None):
    """A `DeviceMesh` of `shape` with dims named `axes`, on `device_type`
    (default: ``cuda`` when the default process group is NCCL's, else
    ``cpu``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type=device_type)


def mesh_shape_from_topology(topology: Topology, *, model_parallelism: int = 8,
                             pods: Optional[int] = None, kind: str = "gpu"):
    """((pod?, data, model) sizes, axis names) for a HiCR topology's devices
    of `kind` (GPUs; ``"cpu"`` for gloo ranks). Raises ValueError if the
    device count does not factor."""
    gpus = [d for d in topology.get_devices() if d.kind == kind]
    n = len(gpus)
    if n == 0:
        raise ValueError(f"topology contains no {kind.upper()} devices")
    pod_ids = sorted({d.attributes.get("pod", 0) for d in gpus})
    n_pods = pods if pods is not None else len(pod_ids)
    per_pod = n // n_pods
    if per_pod % model_parallelism != 0:
        raise ValueError(f"{per_pod} GPUs/pod not divisible by model={model_parallelism}")
    data = per_pod // model_parallelism
    if n_pods > 1:
        return (n_pods, data, model_parallelism), ("pod", "data", "model")
    return (data, model_parallelism), ("data", "model")


def mesh_from_topology(topology: Topology, *, model_parallelism: int = 8,
                       pods: Optional[int] = None, device_type: Optional[str] = None,
                       kind: str = "gpu"):
    """Build a (pod?, data, model) mesh sized by a HiCR topology's GPU
    devices (a ``pod`` attribute groups them; the spec topology's nodes
    carry one). Raises ValueError if the device count does not factor; the
    mesh itself needs a process group of that many ranks."""
    shape, axes = mesh_shape_from_topology(topology, model_parallelism=model_parallelism,
                                           pods=pods, kind=kind)
    return make_mesh(shape, axes, device_type=device_type)
