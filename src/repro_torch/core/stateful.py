"""Stateful HiCR components (paper §3.1).

Stateful components represent objects with a finite lifetime whose internal
state is subject to change (a running thread, a GPU stream, a memory slot).
They are unique and therefore cannot be replicated.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from .definitions import (
    ExecutionStateStatus,
    InstanceStatus,
    LifetimeError,
    ProcessingUnitStatus,
    fresh_id,
)
from .events import Future
from .stateless import ComputeResource, ExecutionUnit, MemorySpace, Topology


class LocalMemorySlot:
    """Source/destination buffer for data transfers within one instance.

    Contains the minimum information required to describe a segment of
    memory: size, starting address (here: a backend-owned buffer handle plus
    an offset), and the memory space it belongs to (paper §3.1.3).
    """

    def __init__(
        self,
        memory_space: MemorySpace,
        size_bytes: int,
        handle: Any,
        *,
        offset: int = 0,
        registered: bool = False,
    ):
        self.slot_id = fresh_id("lslot")
        self.memory_space = memory_space
        self.size_bytes = int(size_bytes)
        self.handle = handle  # backend-specific: bytearray/np.ndarray/jax.Array
        self.offset = int(offset)
        #: True when this slot wraps an externally owned allocation that was
        #: manually registered (paper: registration of existing allocations).
        self.registered = registered
        self.freed = False

    def check_alive(self):
        if self.freed:
            raise LifetimeError(f"memory slot {self.slot_id} already freed")

    def __repr__(self):
        return (
            f"LocalMemorySlot({self.slot_id}, {self.size_bytes}B @ "
            f"{self.memory_space.kind}:{self.memory_space.device_id})"
        )


class GlobalMemorySlot:
    """A local memory slot made accessible to other HiCR instances.

    Uniquely identified by a user-defined (tag, key) pair resulting from a
    collective exchange operation (paper §3.1.4).
    """

    def __init__(
        self,
        tag: int,
        key: int,
        owner_instance_id: str,
        local_slot: Optional[LocalMemorySlot],
        *,
        size_bytes: int,
        fabric_handle: Any = None,
    ):
        self.slot_id = fresh_id("gslot")
        self.tag = int(tag)
        self.key = int(key)
        self.owner_instance_id = owner_instance_id
        #: Non-None only on the owning instance.
        self.local_slot = local_slot
        self.size_bytes = int(size_bytes)
        #: Backend metadata enabling remote access (e.g. fabric address).
        self.fabric_handle = fabric_handle

    @property
    def is_local(self) -> bool:
        return self.local_slot is not None

    def __repr__(self):
        where = "local" if self.is_local else f"remote@{self.owner_instance_id}"
        return f"GlobalMemorySlot(tag={self.tag}, key={self.key}, {where}, {self.size_bytes}B)"


class ExecutionState:
    """The execution lifetime of one instance of an execution unit, including
    the metadata (inputs, continuation, result) required to start, suspend and
    resume (if supported), and finish (paper §3.1.5).

    Once FINISHED, an execution state cannot be re-used.
    """

    def __init__(self, execution_unit: ExecutionUnit, args: tuple = (), kwargs: Mapping[str, Any] | None = None):
        self.state_id = fresh_id("estate")
        self.execution_unit = execution_unit
        self.args = args
        self.kwargs = dict(kwargs or {})
        self.status = ExecutionStateStatus.CREATED
        self.result: Any = None
        self.error: Optional[BaseException] = None
        #: The completion object for this execution: resolved by
        #: mark_finished(); what ComputeManager.execute() hands back.
        self.future = Future(name=f"exec:{execution_unit.name}:{self.state_id}")
        #: Backend-specific continuation (thread handle, generator, future...).
        self.continuation: Any = None

    # -- lifecycle helpers used by compute managers --------------------------
    def mark_executing(self):
        if self.status == ExecutionStateStatus.FINISHED:
            raise LifetimeError("finished execution states cannot be re-used")
        self.status = ExecutionStateStatus.EXECUTING

    def mark_suspended(self):
        if self.status != ExecutionStateStatus.EXECUTING:
            raise LifetimeError(f"cannot suspend from {self.status}")
        self.status = ExecutionStateStatus.SUSPENDED

    def mark_finished(self, result: Any = None, error: BaseException | None = None):
        self.status = ExecutionStateStatus.FINISHED
        self.result = result
        self.error = error
        if error is not None:
            self.future.set_exception(error)
        else:
            self.future.set_result(result)

    # -- completion queries: blocking or non-blocking (paper §3.1.5) --------
    def is_finished(self) -> bool:
        return self.status == ExecutionStateStatus.FINISHED

    def wait(self, timeout: float | None = None) -> bool:
        return self.future.wait(timeout)

    def get_result(self):
        if not self.is_finished():
            raise LifetimeError("execution state not finished")
        if self.error is not None:
            raise self.error
        return self.result


class ProcessingUnit:
    """A compute resource that has been initialized and is ready to execute
    (paper §3.1.5): e.g. a POSIX thread 1:1-bound to a core, an accelerator
    stream context, or a mesh slice prepared as one SPMD computer."""

    def __init__(self, compute_resource: ComputeResource):
        self.pu_id = fresh_id("pu")
        self.compute_resource = compute_resource
        self.status = ProcessingUnitStatus.UNINITIALIZED
        #: Backend-specific context (thread object, device handle, mesh).
        self.context: Any = None
        #: The execution state currently assigned, if any.
        self.current_state: Optional[ExecutionState] = None

    def check_ready(self):
        if self.status not in (
            ProcessingUnitStatus.READY,
            ProcessingUnitStatus.EXECUTING,
        ):
            raise LifetimeError(
                f"processing unit {self.pu_id} not ready (status={self.status})"
            )

    def __repr__(self):
        return f"ProcessingUnit({self.pu_id}, {self.compute_resource.kind}#{self.compute_resource.index}, {self.status.value})"


class Instance:
    """Any subset of the distributed system's hardware capable of executing
    independently (paper §3.1.1). No two running instances share devices; the
    only contact point between instances is distributed-memory communication.
    """

    def __init__(self, instance_id: str, *, is_root: bool = False, topology: Topology | None = None):
        self.instance_id = instance_id
        self._is_root = is_root
        self.status = InstanceStatus.RUNNING
        #: The instance's local topology, if it has been queried/exchanged.
        self.topology = topology
        self.attributes: dict = {}

    def is_root(self) -> bool:
        """Root = first instance (or within the first launch group): a
        tie-breaking mechanism, nothing more (paper §3.1.1)."""
        return self._is_root

    def is_live(self) -> bool:
        """Liveness as a manager/router sees it: RUNNING and nothing else.
        Both a clean terminate and an entry-function failure end liveness."""
        return self.status == InstanceStatus.RUNNING

    def terminate(self):
        self.status = InstanceStatus.TERMINATED

    def mark_failed(self):
        """Record that the instance's entry function raised. A terminate
        requested earlier (cooperative kill) keeps the stronger FAILED
        status so routers can tell crash from drain."""
        self.status = InstanceStatus.FAILED

    def __repr__(self):
        root = ", root" if self._is_root else ""
        return f"Instance({self.instance_id}{root}, {self.status.value})"
