"""Host-CPU backend: the HWLoc + Pthreads analog (paper §4.2).

* TopologyManager — discovers host CPU cores and main memory (HWLoc role).
* MemoryManager — malloc/free/register of host-RAM slots backed by numpy
  byte buffers.
* ComputeManager — processing units are worker threads mapped 1:1 to
  detected compute resources (Pthreads role).
* CommunicationManager — L2L memcpy via host memcpy with mutual-exclusion
  fencing (Pthreads role; paper: "employs the standard C memcpy operation,
  and guarantees correct fencing using mutual exclusion mechanisms").
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core.definitions import (
    ComputeResourceKind,
    HiCRError,
    InvalidMemcpyDirectionError,
    LifetimeError,
    MemcpyDirection,
    MemorySpaceKind,
    ProcessingUnitStatus,
    UnsupportedOperationError,
)
from repro_torch.core.events import Event, Future
from repro_torch.core.managers import (
    CommunicationManager,
    ComputeManager,
    InstanceManager,
    MemoryManager,
    TopologyManager,
)
from repro_torch.core.stateful import ExecutionState, Instance, LocalMemorySlot, ProcessingUnit
from repro_torch.core.stateless import (
    ComputeResource,
    Device,
    ExecutionUnit,
    InstanceTemplate,
    MemorySpace,
    Topology,
)


def _host_memory_bytes() -> int:
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):  # pragma: no cover
        return 8 << 30


class HostTopologyManager(TopologyManager):
    """HWLoc analog: hierarchical view of CPU cores and their memory."""

    backend_name = "hostcpu"

    def __init__(self, *, numa_domains: int = 1):
        self._numa_domains = max(1, numa_domains)

    def query_topology(self) -> Topology:
        n_cores = os.cpu_count() or 1
        mem = _host_memory_bytes()
        devices = []
        per_domain_cores = max(1, n_cores // self._numa_domains)
        for dom in range(self._numa_domains):
            dev_id = f"host-numa{dom}"
            lo = dom * per_domain_cores
            hi = n_cores if dom == self._numa_domains - 1 else lo + per_domain_cores
            cores = tuple(
                ComputeResource(
                    kind=ComputeResourceKind.CPU_CORE.value,
                    index=i,
                    device_id=dev_id,
                )
                for i in range(lo, hi)
            )
            spaces = (
                MemorySpace(
                    kind=(
                        MemorySpaceKind.HOST_RAM.value
                        if self._numa_domains == 1
                        else MemorySpaceKind.NUMA_DOMAIN.value
                    ),
                    index=dom,
                    device_id=dev_id,
                    size_bytes=mem // self._numa_domains,
                ),
            )
            devices.append(
                Device(
                    device_id=dev_id,
                    kind="cpu",
                    compute_resources=cores,
                    memory_spaces=spaces,
                )
            )
        return Topology(devices=tuple(devices))


class HostMemoryManager(MemoryManager):
    """malloc/free interface over host RAM, with explicit memory-space choice
    and manual registration of external allocations (paper §3.1.3)."""

    backend_name = "hostcpu"

    def __init__(self, topology: Topology | None = None):
        self._topology = topology or HostTopologyManager().query_topology()
        self._spaces = tuple(self._topology.all_memory_spaces())
        self._live: set[str] = set()

    def memory_spaces(self) -> Sequence[MemorySpace]:
        return self._spaces

    def allocate_local_memory_slot(self, space: MemorySpace, size_bytes: int) -> LocalMemorySlot:
        self._check_space(space)
        if size_bytes <= 0:
            raise ValueError("allocation size must be positive")
        buf = np.zeros(size_bytes, dtype=np.uint8)
        slot = LocalMemorySlot(space, size_bytes, buf)
        self._live.add(slot.slot_id)
        return slot

    def register_local_memory_slot(self, space: MemorySpace, buffer: Any, size_bytes: int) -> LocalMemorySlot:
        self._check_space(space)
        view = np.frombuffer(buffer, dtype=np.uint8) if not isinstance(buffer, np.ndarray) else buffer.view(np.uint8).reshape(-1)
        if view.nbytes < size_bytes:
            raise ValueError("registered buffer smaller than declared size")
        slot = LocalMemorySlot(space, size_bytes, view, registered=True)
        self._live.add(slot.slot_id)
        return slot

    def free_local_memory_slot(self, slot: LocalMemorySlot) -> None:
        slot.check_alive()
        slot.freed = True
        self._live.discard(slot.slot_id)

    @property
    def live_slot_count(self) -> int:
        return len(self._live)


class HostInstanceManager(InstanceManager):
    """Single-instance view of the host process (paper §3.1.1).

    The host process IS the one (root) instance. Elastic creation is a
    *template-validated stub path*: ``create_instances`` checks the template
    against the real host topology — so callers get exactly the same
    template errors as on an elastic backend — and then reports the spawn
    itself as unsupported, because one OS process cannot host a second HiCR
    instance (no distributed-memory boundary to put between them)."""

    backend_name = "hostcpu"

    def __init__(self, topology: Topology | None = None):
        self._topology = topology or HostTopologyManager().query_topology()
        self._self = Instance("host-0", is_root=True, topology=self._topology)

    def get_instances(self) -> Sequence[Instance]:
        return (self._self,)

    def get_current_instance(self) -> Instance:
        return self._self

    def create_instances(self, count: int, template: InstanceTemplate) -> Sequence[Instance]:
        if count < 1:
            raise ValueError("count must be >= 1")
        # validation first: an unsatisfiable template is the caller's bug and
        # must surface as such, not be masked by the capability error
        if not self._topology.satisfies(template):
            raise HiCRError("host topology cannot satisfy instance template")
        raise UnsupportedOperationError(
            "hostcpu is single-instance: template validated, but spawning "
            "requires a multi-instance backend (localsim/spmd)"
        )

    def terminate_instance(self, instance: Instance) -> None:
        raise UnsupportedOperationError(
            "hostcpu cannot terminate the instance it runs inside"
        )


class HostCommunicationManager(CommunicationManager):
    """Local-to-Local memcpy over host buffers. Transfers are executed by a
    background copier thread so that memcpy() is genuinely asynchronous: the
    returned transfer Event is signalled by the copier once the bytes have
    landed; fence() is the base-class wait over the tag's event set."""

    backend_name = "hostcpu"

    def __init__(self):
        self._queue: "queue.Queue[tuple | None]" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True, name="hostcpu-copier")
        self._worker.start()

    def _run(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            dst, dst_off, src, src_off, size, event = item
            dview = dst.handle.view(np.uint8).reshape(-1)
            sview = src.handle.view(np.uint8).reshape(-1)
            dview[dst.offset + dst_off : dst.offset + dst_off + size] = sview[
                src.offset + src_off : src.offset + src_off + size
            ]
            event.set()

    def _memcpy_impl(self, direction, dst, dst_off, src, src_off, size):
        if direction != MemcpyDirection.LOCAL_TO_LOCAL:
            raise InvalidMemcpyDirectionError(
                "hostcpu communication manager only supports Local-to-Local"
            )
        dst.check_alive()
        src.check_alive()
        if dst_off + size > dst.size_bytes or src_off + size > src.size_bytes:
            raise ValueError("memcpy out of slot bounds")
        event = Event(name="hostcpu-memcpy")
        self._queue.put((dst, dst_off, src, src_off, size, event))
        return event

    def exchange_global_memory_slots(self, tag, local_slots):
        from repro_torch.core.definitions import UnsupportedOperationError

        raise UnsupportedOperationError(
            "hostcpu backend is single-instance; use the localsim/spmd backend "
            "for global memory slots"
        )

    def shutdown(self):
        self._queue.put(None)
        self._worker.join(timeout=5)


class _Worker(threading.Thread):
    """A system thread bound 1:1 to a compute resource (Pthreads analog)."""

    def __init__(self, pu: ProcessingUnit):
        super().__init__(daemon=True, name=f"hostcpu-{pu.pu_id}")
        self.pu = pu
        self.inbox: "queue.Queue[ExecutionState | None]" = queue.Queue()

    def run(self):
        while True:
            state = self.inbox.get()
            if state is None:
                return
            state.mark_executing()
            try:
                result = state.execution_unit.fn(*state.args, **state.kwargs)
                state.mark_finished(result=result)
            except BaseException as e:  # noqa: BLE001 - report through the state
                state.mark_finished(error=e)


class HostComputeManager(ComputeManager):
    """Pthreads analog: processing units are worker threads; execution is
    asynchronous; completion can be queried blocking or non-blocking."""

    backend_name = "hostcpu"
    supported_formats = ("python-callable",)
    supports_suspension = False

    def create_processing_unit(self, resource: ComputeResource) -> ProcessingUnit:
        return ProcessingUnit(resource)

    def create_execution_state(self, unit: ExecutionUnit, *args, **kwargs) -> ExecutionState:
        self.check_format(unit)
        return ExecutionState(unit, args, kwargs)

    def initialize(self, pu: ProcessingUnit) -> None:
        if pu.status != ProcessingUnitStatus.UNINITIALIZED:
            raise LifetimeError("processing unit already initialized")
        worker = _Worker(pu)
        pu.context = worker
        worker.start()
        pu.status = ProcessingUnitStatus.READY

    def execute(self, pu: ProcessingUnit, state: ExecutionState) -> Future:
        pu.check_ready()
        if state.is_finished():
            raise LifetimeError("finished execution states cannot be re-used")
        pu.current_state = state
        pu.status = ProcessingUnitStatus.EXECUTING
        pu.context.inbox.put(state)
        return state.future

    def finalize(self, pu: ProcessingUnit) -> None:
        if pu.status == ProcessingUnitStatus.TERMINATED:
            return
        if pu.context is not None:
            pu.context.inbox.put(None)
            pu.context.join(timeout=5)
        pu.status = ProcessingUnitStatus.TERMINATED


def make_managers(*, numa_domains: int = 1) -> Mapping[str, object]:
    tm = HostTopologyManager(numa_domains=numa_domains)
    topo = tm.query_topology()
    return {
        "topology": tm,
        "instance": HostInstanceManager(topo),
        "memory": HostMemoryManager(topo),
        "communication": HostCommunicationManager(),
        "compute": HostComputeManager(),
    }
