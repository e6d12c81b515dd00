"""Built-in backends of the port. Importing this package registers them
with the core registry.

  backend    | topology | instance | communication | memory | compute
  -----------+----------+----------+---------------+--------+--------
  hostcpu    |    X     |    X*    |      X        |   X    |   X      (HWLoc+Pthreads)
  coroutine  |          |          |               |        |   X      (Boost)
  localsim   |          |    X     |      X        |        |          (MPI/LPF)
  torchdev   |    X     |          |      X        |   X    |   X      (CUDA / host via PyTorch)

  X* — hostcpu's instance manager is the single-instance view: templates
  are validated against the host topology, but elastic creation reports
  UnsupportedOperationError (one OS process is one instance).

`hostcpu`, `coroutine` and `localsim` are own copies of the reference's
`repro/backends/` modules with only the package prefix changed; `torchdev`
takes `jaxdev`'s row. The reference's multi-device backends (spmd,
tpu_spec) have no counterpart yet.
"""
from repro_torch.core.registry import register_backend

from . import coroutine, hostcpu, localsim, torchdev  # noqa: F401

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
    "coroutine",
    {"compute": coroutine.CoroutineComputeManager},
    description="Boost.Context analog: suspendable coroutine execution states",
)

register_backend(
    "localsim",
    {
        # instance/communication managers are per-world; expose factories that
        # require a world handle.
        "instance": localsim.LocalSimInstanceManager,
        "communication": localsim.LocalSimCommunicationManager,
    },
    description="MPI/LPF analog: thread instances over an in-process fabric",
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

__all__ = ["coroutine", "hostcpu", "localsim", "torchdev"]
