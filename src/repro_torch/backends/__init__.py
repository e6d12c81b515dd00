"""Built-in backends of the port. Importing this package registers them
with the core registry.

  backend    | topology | instance | communication | memory | compute
  -----------+----------+----------+---------------+--------+--------
  torchdev   |    X     |          |      X        |   X    |   X      (CUDA / host via PyTorch)

The reference's other backends (hostcpu, coroutine, localsim, spmd,
tpu_spec) are not ported yet.
"""
from repro_torch.core.registry import register_backend

from . import torchdev  # noqa: F401

register_backend(
    "torchdev",
    {
        "topology": torchdev.TorchTopologyManager,
        "memory": torchdev.TorchMemoryManager,
        "communication": torchdev.TorchCommunicationManager,
        "compute": torchdev.TorchComputeManager,
    },
    description="ACL/OpenCL analog: one torch device (CUDA, or the CPU when asked)",
)

__all__ = ["torchdev"]
