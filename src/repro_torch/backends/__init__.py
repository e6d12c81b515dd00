"""Built-in backends of the port. Importing this package registers them
with the core registry.

  backend    | topology | instance | communication | memory | compute
  -----------+----------+----------+---------------+--------+--------
  hostcpu    |    X     |    X*    |      X        |   X    |   X      (HWLoc+Pthreads)
  torchdev   |    X     |          |      X        |   X    |   X      (CUDA / host via PyTorch)

  X* — hostcpu's instance manager is the single-instance view: templates
  are validated against the host topology, but elastic creation reports
  UnsupportedOperationError (one OS process is one instance).

`hostcpu` is an own copy of the reference's `repro/backends/hostcpu.py`
with only the package prefix changed. The reference's other backends
(coroutine, localsim, spmd, tpu_spec) are not ported yet.
"""
from repro_torch.core.registry import register_backend

from . import hostcpu, torchdev  # noqa: F401

register_backend(
    "hostcpu",
    {
        "topology": hostcpu.HostTopologyManager,
        "instance": hostcpu.HostInstanceManager,
        "memory": hostcpu.HostMemoryManager,
        "communication": hostcpu.HostCommunicationManager,
        "compute": hostcpu.HostComputeManager,
    },
    description="HWLoc+Pthreads analog: host cores, host RAM, threaded compute",
)

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

__all__ = ["hostcpu", "torchdev"]
