"""Static H100 topology backend: the port's counterpart of the reference's
`repro/backends/tpu_spec.py`.

The paper's topology managers discover *present* hardware; this backend
instead synthesises a target system's topology (nodes of 8 H100 SXM5 GPUs
joined by NVLink) so that planning — mesh construction, dry runs, roofline
analysis — can run on a CPU-only machine. It plays the role of a vendor
spec-sheet-driven TopologyManager and is the one source of the hardware
constants used by `repro_torch.launch.roofline` and `chip_smoke.py`'s
bounds. The NVLink domain of a node takes the place of a TPU pod's ICI.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.definitions import ComputeResourceKind, MemorySpaceKind
from repro_torch.core.managers import TopologyManager
from repro_torch.core.stateless import ComputeResource, Device, MemorySpace, Topology


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """The reference's fields: `ici_*` hold the chip-to-chip links (NVLink
    here), `vmem_bytes` the on-chip scratch a kernel manages (an SM's shared
    memory)."""

    name: str
    peak_flops_bf16: float
    hbm_bytes: int
    hbm_bandwidth: float
    ici_bandwidth_per_link: float
    ici_links_per_chip: int
    vmem_bytes: int


#: NVIDIA H100 SXM5 80 GB, from NVIDIA's datasheet (not measured here):
#: 989 TFLOP/s dense bf16 tensor-core peak, 80 GB of HBM3 at 3.35 TB/s,
#: NVLink 4 with 18 links of 50 GB/s (900 GB/s a GPU), 228 KB of shared
#: memory an SM.
H100 = ChipSpec(
    name="h100-sxm5",
    peak_flops_bf16=989e12,
    hbm_bytes=80 * 10**9,
    hbm_bandwidth=3.35e12,
    ici_bandwidth_per_link=50e9,
    ici_links_per_chip=18,
    vmem_bytes=228 * 1024,
)

#: the same datasheet's other peaks that bounds need: fp32 arithmetic on the
#: CUDA cores (67 TFLOP/s dense), TF32 on the tensor cores (495 TFLOP/s
#: dense: the fp32 flash backward's products, three TF32 products each), and
#: the L2 cache (50 MB): inputs cycled past twice this are read cold
PEAK_FLOPS = {"bfloat16": H100.peak_flops_bf16, "float32": 67e12, "tfloat32": 495e12}
L2_BYTES = 50 * 2**20

#: GPUs a node (one NVLink domain)
GPUS_PER_NODE = 8


def node_topology(*, nodes: int = 1, gpus_per_node: int = GPUS_PER_NODE,
                  chip: ChipSpec = H100) -> Topology:
    """Synthesise a `nodes`-node topology of `gpus_per_node` GPUs each.
    Each device's ``node`` attribute plays the reference's ``pod``."""
    devices = []
    for n in range(nodes):
        for g in range(gpus_per_node):
            dev_id = f"{chip.name}-node{n}-{g}"
            cr = ComputeResource(
                kind=ComputeResourceKind.ACCELERATOR_STREAM.value,
                index=n * gpus_per_node + g,
                device_id=dev_id,
                peak_flops_bf16=chip.peak_flops_bf16,
                attributes={"node": n, "local_rank": g},
            )
            hbm = MemorySpace(
                kind=MemorySpaceKind.DEVICE_HBM.value,
                index=0,
                device_id=dev_id,
                size_bytes=chip.hbm_bytes,
                bandwidth_bytes_per_s=chip.hbm_bandwidth,
            )
            smem = MemorySpace(
                kind=MemorySpaceKind.DEVICE_VMEM.value,
                index=1,
                device_id=dev_id,
                size_bytes=chip.vmem_bytes,
                bandwidth_bytes_per_s=0.0,
                attributes={"kernel_managed": True},
            )
            devices.append(
                Device(
                    device_id=dev_id,
                    kind="gpu",
                    compute_resources=(cr,),
                    memory_spaces=(hbm, smem),
                    attributes={
                        "node": n,
                        "pod": n,
                        "local_rank": g,
                        "ici_bandwidth_per_link": chip.ici_bandwidth_per_link,
                        "ici_links": chip.ici_links_per_chip,
                    },
                )
            )
    return Topology(devices=tuple(devices))


class SpecTopologyManager(TopologyManager):
    """TopologyManager whose 'discovery' is the declared target system."""

    backend_name = "h100_spec"

    def __init__(self, *, nodes: int = 1, gpus_per_node: int = GPUS_PER_NODE,
                 chip: ChipSpec = H100):
        self.nodes = nodes
        self.gpus_per_node = gpus_per_node
        self.chip = chip

    def query_topology(self) -> Topology:
        return node_topology(nodes=self.nodes, gpus_per_node=self.gpus_per_node, chip=self.chip)
