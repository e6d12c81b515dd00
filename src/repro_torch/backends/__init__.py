"""Built-in backends of the port. Importing this package registers them
with the core registry.

  backend    | topology | instance | communication | memory | compute
  -----------+----------+----------+---------------+--------+--------
  hostcpu    |    X     |    X*    |      X        |   X    |   X      (HWLoc+Pthreads)
  coroutine  |          |          |               |        |   X      (Boost)
  localsim   |          |    X     |      X        |        |          (MPI/LPF)
  torchdev   |    X     |          |      X        |   X    |   X      (CUDA / host via PyTorch)
  spmd       |          |    X     |      X        |        |   X      (torch.distributed)
  h100_spec  |    X     |          |               |        |          (spec-sheet)

  X* — hostcpu's instance manager is the single-instance view: templates
  are validated against the host topology, but elastic creation reports
  UnsupportedOperationError (one OS process is one instance).

`hostcpu`, `coroutine` and `localsim` are own copies of the reference's
`repro/backends/` modules with only the package prefix changed; `torchdev`
takes `jaxdev`'s row, `spmd` the reference's XLA SPMD row (NCCL / gloo /
fake process groups, DTensor over a `DeviceMesh`), `h100_spec` its
`tpu_spec` row (a synthesised topology of 8-GPU NVLink nodes).
"""
from repro_torch.core.registry import register_backend

from . import coroutine, gpu_spec, hostcpu, localsim, spmd, torchdev  # noqa: F401

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

register_backend(
    "spmd",
    {
        "instance": spmd.SpmdInstanceManager,
        "communication": spmd.SpmdCommunicationManager,
        "compute": spmd.SpmdComputeManager,
    },
    description="torch.distributed SPMD: mesh programs over DTensors, collectives as communication",
)

register_backend(
    "h100_spec",
    {"topology": gpu_spec.SpecTopologyManager},
    description="Target-system topology from the H100 SXM5 datasheet",
)

__all__ = ["coroutine", "gpu_spec", "hostcpu", "localsim", "spmd", "torchdev"]
