"""Abstract HiCR managers (paper §3.1, Fig. 2).

Managers are the effectful components of the model: they trigger
computation, copy data between devices, or create new application instances.
Only managers can create instances of other components.

Each manager is an abstract class; *backends* derive them into complete
classes (paper §4.1). A HiCR application receives managers as abstract
references and thus remains agnostic to the specific backend choice.
"""
from __future__ import annotations

import abc
import threading
from typing import Any, Callable, Mapping, Optional, Sequence

from .definitions import (
    InvalidMemcpyDirectionError,
    LifetimeError,
    MemcpyDirection,
    NoRootInstanceError,
    ProcessingUnitStatus,
    UnsupportedOperationError,
)
from .events import Event, Future, completed_event
from .stateful import (
    ExecutionState,
    GlobalMemorySlot,
    Instance,
    LocalMemorySlot,
    ProcessingUnit,
)
from .stateless import (
    ComputeResource,
    ExecutionUnit,
    InstanceTemplate,
    MemorySpace,
    Topology,
)


class TopologyManager(abc.ABC):
    """Discovers full or partial hardware topology (paper §3.1.2).

    A combination of topology managers, each targeting a specific technology,
    gathers the full picture of the local instance; topologies serialize for
    broadcast so a global system view can be assembled.
    """

    backend_name: str = "abstract"

    @abc.abstractmethod
    def query_topology(self) -> Topology:
        ...


class MemoryManager(abc.ABC):
    """Creation, registration and destruction of local memory slots
    (paper §3.1.3). Interface mirrors malloc/free but takes an explicit
    MemorySpace selecting the device sourcing the allocation."""

    backend_name: str = "abstract"

    @abc.abstractmethod
    def memory_spaces(self) -> Sequence[MemorySpace]:
        """The memory spaces this manager can operate on."""

    @abc.abstractmethod
    def allocate_local_memory_slot(self, space: MemorySpace, size_bytes: int) -> LocalMemorySlot:
        ...

    @abc.abstractmethod
    def register_local_memory_slot(self, space: MemorySpace, buffer: Any, size_bytes: int) -> LocalMemorySlot:
        """Manually record an existing external allocation as a memory slot
        (e.g. one received from a math library)."""

    @abc.abstractmethod
    def free_local_memory_slot(self, slot: LocalMemorySlot) -> None:
        ...

    # -- helper shared by backends -------------------------------------------
    def _check_space(self, space: MemorySpace):
        from .definitions import MemorySpaceMismatchError

        known = {(s.kind, s.index, s.device_id) for s in self.memory_spaces()}
        if (space.kind, space.index, space.device_id) not in known:
            raise MemorySpaceMismatchError(
                f"{type(self).__name__} cannot operate on memory space "
                f"{space.kind}:{space.device_id}:{space.index}"
            )

    # -- pool helpers ---------------------------------------------------------
    def register_tensor_slot(self, space: MemorySpace, array: Any) -> LocalMemorySlot:
        """Register a framework tensor (anything exposing ``nbytes``) as a
        local memory slot — the paper's registration of an allocation
        received from a math library (§3.1.3), here a device array the
        serving layer allocated through jax."""
        nbytes = int(getattr(array, "nbytes", 0))
        if nbytes <= 0:
            raise ValueError("tensor has no bytes to register")
        return self.register_local_memory_slot(space, array, nbytes)

    def create_slot_pool(
        self, space: MemorySpace, block_bytes: int, n_blocks: int, **kwargs
    ) -> "MemorySlotPool":
        """Allocate ONE backing slot of `n_blocks` fixed-size blocks and wrap
        it in a `MemorySlotPool`: sub-allocation then happens by block index,
        without further manager round-trips (allocate-once, place-many)."""
        backing = self.allocate_local_memory_slot(space, block_bytes * n_blocks)
        return MemorySlotPool(block_bytes, n_blocks, backing=(backing,), **kwargs)


class MemorySlotPool:
    """Fixed-size block pool over memory slots allocated/registered ONCE
    through a `MemoryManager` (paper §3.1.3: the runtime owns placement, the
    hot path only moves indices).

    Blocks are handed out as integer indices. Admission is reservation-based:
    `reserve(n)` claims capacity up front (so a consumer admitted against the
    pool can never starve mid-flight), while `draw(n)` materializes physical
    block indices lazily against the caller's reservation. `free(blocks)`
    returns physical blocks; `unreserve(n)` returns unclaimed capacity.

    Blocks are reference-counted so several holders can share one physical
    block (fork-by-reference, the prefix-cache ownership model): `draw` hands
    a block out with refcount 1, `acquire`/`share` add a holder, and
    `release`/`free` drop one — the block only returns to the free list when
    its last holder lets go. Dropping a holder from a block that has none
    (a double-free) raises `LifetimeError` instead of silently corrupting
    the free list with a duplicate entry.

    `block_slot(backing_idx, block)` describes one block as a registered
    sub-slot (offset view) of a backing slot — the form a communication
    manager can memcpy from/to.
    """

    def __init__(
        self,
        block_bytes: int,
        n_blocks: int,
        *,
        backing: Sequence[LocalMemorySlot] = (),
        reserved_blocks: Sequence[int] = (),
    ):
        if n_blocks <= 0:
            raise ValueError("pool needs at least one block")
        self.block_bytes = int(block_bytes)
        self.n_blocks = int(n_blocks)
        self.backing = tuple(backing)
        pinned = set(reserved_blocks)
        self._free: list[int] = [i for i in range(n_blocks) if i not in pinned]
        self._capacity = len(self._free)
        self._reserved = 0
        #: block -> holder count; only allocated blocks have an entry
        self._refs: dict[int, int] = {}

    # -- introspection -------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Allocatable blocks (pinned blocks, e.g. a null page, excluded)."""
        return self._capacity

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_used(self) -> int:
        return self._capacity - len(self._free)

    @property
    def blocks_available(self) -> int:
        """Free blocks not spoken for by an outstanding reservation."""
        return len(self._free) - self._reserved

    # -- reservation-based allocation ---------------------------------------
    def can_reserve(self, n: int) -> bool:
        return n <= self.blocks_available

    def reserve(self, n: int) -> bool:
        """Claim capacity for `n` blocks to be drawn later. Returns False
        (no side effect) when the pool cannot guarantee them."""
        if not self.can_reserve(n):
            return False
        self._reserved += n
        return True

    def unreserve(self, n: int) -> None:
        self._reserved -= n
        if self._reserved < 0:  # pragma: no cover - caller bookkeeping bug
            raise ValueError("unreserve exceeds outstanding reservations")

    def draw(self, n: int) -> list[int]:
        """Materialize `n` physical blocks against an earlier reservation."""
        if n > self._reserved:
            raise ValueError(f"draw({n}) exceeds reservation ({self._reserved})")
        if n > len(self._free):  # pragma: no cover - reservation guards this
            raise ValueError("pool out of blocks despite reservation")
        self._reserved -= n
        out, self._free = self._free[:n], self._free[n:]
        for b in out:
            self._refs[b] = 1
        return out

    # -- reference counting (shared blocks) ----------------------------------
    def refcount(self, block: int) -> int:
        """Current holder count of `block` (0 = free / never drawn)."""
        return self._refs.get(block, 0)

    def acquire(self, blocks: Sequence[int]) -> None:
        """Add one holder to each of `blocks` (fork-by-reference). Acquiring
        a block no one holds is a lifetime bug: the content it guards may
        already have been reallocated."""
        for b in blocks:
            if self._refs.get(b, 0) <= 0:
                raise LifetimeError(
                    f"acquire of block {b} which is not allocated"
                )
        for b in blocks:
            self._refs[b] += 1

    # `share` is the paper-facing name for adding a holder to an existing
    # allocation (fork-by-reference); identical to `acquire`.
    share = acquire

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one holder from each of `blocks`; a block whose last holder
        releases returns to the free list. Releasing an unallocated block
        (double-free) raises `LifetimeError` — silently re-appending it
        would hand the same block out twice. Validation runs over the whole
        list BEFORE any mutation (like `acquire`), so a rejected call
        leaves the pool exactly as it found it."""
        drops: dict[int, int] = {}
        for b in blocks:
            if not 0 <= b < self.n_blocks:
                raise ValueError(f"block {b} out of range [0, {self.n_blocks})")
            drops[b] = drops.get(b, 0) + 1
        for b, k in drops.items():
            if self._refs.get(b, 0) < k:
                raise LifetimeError(
                    f"double free: block {b} has {self._refs.get(b, 0)} "
                    f"holder(s), release of {k} requested"
                )
        for b, k in drops.items():
            count = self._refs[b] - k
            if count == 0:
                del self._refs[b]
                self._free.append(b)
            else:
                self._refs[b] = count

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one holder per block — with unshared blocks (refcount 1,
        the pre-refcounting common case) this frees them outright."""
        self.release(blocks)

    # -- HiCR slot views ------------------------------------------------------
    def block_slot(self, backing_idx: int, block: int) -> LocalMemorySlot:
        base = self.backing[backing_idx]
        return LocalMemorySlot(
            base.memory_space,
            self.block_bytes,
            base.handle,
            offset=base.offset + block * self.block_bytes,
            registered=True,
        )


class CommunicationManager(abc.ABC):
    """Mediates all communication via memcpy/fence and creates/exchanges
    global memory slots (paper §3.1.4).

    `memcpy` returns a transfer `Event`; `fence(tag)` is implemented here,
    once, on top of per-tag event sets — a backend only produces one Event
    per transfer (or None for synchronous copies) and the bookkeeping is
    shared. Backends with their own completion machinery may still override
    `fence`, but none of the built-ins need to.
    """

    backend_name: str = "abstract"

    # -- direction classification (model-level, shared by all backends) ------
    @staticmethod
    def classify(src, dst) -> MemcpyDirection:
        src_global = isinstance(src, GlobalMemorySlot)
        dst_global = isinstance(dst, GlobalMemorySlot)
        if src_global and dst_global:
            # Global-to-Global entails communication between two remote
            # instances, neither of which orchestrates the operation —
            # forbidden by the model.
            raise InvalidMemcpyDirectionError(
                "Global-to-Global memcpy is not permitted by the HiCR model"
            )
        if not src_global and not dst_global:
            return MemcpyDirection.LOCAL_TO_LOCAL
        if dst_global:
            return MemcpyDirection.LOCAL_TO_GLOBAL
        return MemcpyDirection.GLOBAL_TO_LOCAL

    def memcpy(self, dst, dst_offset: int, src, src_offset: int, size_bytes: int) -> Event:
        """Initiate a (possibly asynchronous) data transfer. Completion is
        NOT guaranteed when the call returns — wait on the returned Event,
        or fence() the transfer's tag (global-slot transfers belong to the
        slot's exchange tag; local-to-local transfers belong to tag 0)."""
        direction = self.classify(src, dst)
        event = self._memcpy_impl(direction, dst, dst_offset, src, src_offset, size_bytes)
        if event is None:  # synchronous backend: completion is immediate
            event = completed_event(name="memcpy")
        self._record_transfer(self._transfer_tag(dst, src), event)
        return event

    @abc.abstractmethod
    def _memcpy_impl(
        self,
        direction: MemcpyDirection,
        dst,
        dst_offset: int,
        src,
        src_offset: int,
        size_bytes: int,
    ) -> Optional[Event]:
        """Perform/enqueue the transfer; return its completion Event, or
        None when the copy completed synchronously."""

    @staticmethod
    def _transfer_tag(dst, src) -> int:
        if isinstance(dst, GlobalMemorySlot):
            return dst.tag
        if isinstance(src, GlobalMemorySlot):
            return src.tag
        return 0

    def _record_transfer(self, tag: int, event: Event) -> None:
        """Track `event` in `tag`'s pending set (pruning settled entries so
        an unfenced tag cannot grow without bound)."""
        if "_transfer_lock" not in self.__dict__:
            # lazily created: backends are not required to call our __init__
            self.__dict__.setdefault("_transfer_lock", threading.Lock())
            self.__dict__.setdefault("_transfer_events", {})
        with self._transfer_lock:
            pending = self._transfer_events.setdefault(tag, [])
            if len(pending) > 64:
                # done() rather than the raw flag: poll-backed transfer
                # events (XLA readiness) only resolve when asked
                pending[:] = [e for e in pending if not e.done()]
            pending.append(event)

    def fence(self, tag: int = 0) -> None:
        """Suspend execution until the expected incoming and outgoing
        transfers of `tag` have completed (paper §3.1.4). Implemented on the
        per-tag set of transfer Events this manager recorded.

        Waits a *snapshot* of the tag's pending set rather than popping it:
        with several threads fencing one manager, each fence must wait its
        own thread's transfers even when another fence is in flight (the
        counter-based implementations this replaces guaranteed that)."""
        if "_transfer_lock" not in self.__dict__:
            return  # no transfer ever recorded
        with self._transfer_lock:
            events = list(self._transfer_events.get(tag, ()))
        for event in events:
            event.wait()
        with self._transfer_lock:
            pending = self._transfer_events.get(tag)
            if pending is not None:
                pending[:] = [e for e in pending if e not in events]
                if not pending:
                    del self._transfer_events[tag]

    # -- global memory slots --------------------------------------------------
    @abc.abstractmethod
    def exchange_global_memory_slots(
        self, tag: int, local_slots: Mapping[int, LocalMemorySlot]
    ) -> Mapping[int, GlobalMemorySlot]:
        """Collective: every instance volunteers zero or more local slots
        (keyed by a user-defined key); returns the union of all exchanged
        slots as global memory slots addressed by (tag, key)."""

    def destroy_global_memory_slot(self, slot: GlobalMemorySlot) -> None:  # pragma: no cover - default
        raise UnsupportedOperationError(f"{type(self).__name__} cannot destroy global slots")


class ComputeManager(abc.ABC):
    """Carries out computing operations: manages the lifetime of processing
    units, prescribes the format of execution units, and oversees execution
    states (paper §3.1.5)."""

    backend_name: str = "abstract"
    #: Execution-unit formats this manager accepts.
    supported_formats: Sequence[str] = ("python-callable",)
    #: Whether execution states may be suspended/resumed.
    supports_suspension: bool = False

    # -- component creation ----------------------------------------------------
    def create_execution_unit(self, fn: Callable, *, name: str = "anonymous", **metadata) -> ExecutionUnit:
        return ExecutionUnit(name=name, format=self.supported_formats[0], fn=fn, metadata=metadata)

    @abc.abstractmethod
    def create_processing_unit(self, resource: ComputeResource) -> ProcessingUnit:
        ...

    @abc.abstractmethod
    def create_execution_state(
        self, unit: ExecutionUnit, *args, **kwargs
    ) -> ExecutionState:
        ...

    # -- lifecycle ---------------------------------------------------------------
    @abc.abstractmethod
    def initialize(self, pu: ProcessingUnit) -> None:
        ...

    @abc.abstractmethod
    def execute(self, pu: ProcessingUnit, state: ExecutionState) -> Future:
        """Assign `state` to `pu`, start computing it asynchronously, and
        return the state's completion Future (`state.future`): `result()`
        yields the execution unit's return value or re-raises its error."""

    def suspend(self, pu: ProcessingUnit) -> None:
        raise UnsupportedOperationError(f"{type(self).__name__} does not support suspension")

    def resume(self, pu: ProcessingUnit) -> None:
        raise UnsupportedOperationError(f"{type(self).__name__} does not support suspension")

    def await_(self, pu: ProcessingUnit) -> None:
        """Block until the processing unit's current execution state finishes.

        .. deprecated:: use the Future returned by `execute()` instead; this
           is a thin shim kept for pre-Future callers.
        """
        state = pu.current_state
        if state is not None:
            state.future.wait()
        pu.status = ProcessingUnitStatus.READY

    @abc.abstractmethod
    def finalize(self, pu: ProcessingUnit) -> None:
        """Terminate the processing unit and free its resources."""

    def check_format(self, unit: ExecutionUnit):
        if unit.format not in self.supported_formats:
            raise UnsupportedOperationError(
                f"{type(self).__name__} accepts formats {self.supported_formats}, "
                f"got {unit.format!r}"
            )


class InstanceManager(abc.ABC):
    """Handles all operations involving instances (paper §3.1.1): detecting
    launch-time instances, creating instances at runtime from templates, and
    root-instance designation."""

    backend_name: str = "abstract"

    @abc.abstractmethod
    def get_instances(self) -> Sequence[Instance]:
        ...

    @abc.abstractmethod
    def get_current_instance(self) -> Instance:
        ...

    def get_root_instance(self) -> Instance:
        for inst in self.get_instances():
            if inst.is_root():
                return inst
        raise NoRootInstanceError("no root instance found")

    def live_instances(self) -> Sequence[Instance]:
        """Instances still RUNNING — the set a router may assign work to.
        Terminated and failed instances are excluded alike."""
        return tuple(inst for inst in self.get_instances() if inst.is_live())

    def create_instance_template(self, **requirements) -> InstanceTemplate:
        return InstanceTemplate(**requirements)

    def create_instances(self, count: int, template: InstanceTemplate) -> Sequence[Instance]:
        raise UnsupportedOperationError(
            f"{type(self).__name__} cannot create instances at runtime"
        )

    def terminate_instance(self, instance: Instance) -> None:
        raise UnsupportedOperationError(
            f"{type(self).__name__} cannot terminate instances"
        )

    # -- RPC-ish primitives used by the RPC frontend ---------------------------
    def send_message(self, instance: Instance, payload: bytes) -> None:
        raise UnsupportedOperationError(f"{type(self).__name__} has no message path")

    def recv_message(self, timeout: float | None = None) -> Optional[bytes]:
        raise UnsupportedOperationError(f"{type(self).__name__} has no message path")


class ManagerSet:
    """Convenience bundle: the set of managers a HiCR application receives.

    Mirrors the paper's usage pattern (Fig. 4): backends are instantiated by
    the launcher and passed by reference; the application only sees abstract
    classes.
    """

    def __init__(
        self,
        *,
        instance_manager: InstanceManager | None = None,
        topology_managers: Sequence[TopologyManager] = (),
        memory_manager: MemoryManager | None = None,
        communication_manager: CommunicationManager | None = None,
        compute_manager: ComputeManager | None = None,
        task_compute_manager: ComputeManager | None = None,
    ):
        self.instance_manager = instance_manager
        self.topology_managers = tuple(topology_managers)
        self.memory_manager = memory_manager
        self.communication_manager = communication_manager
        self.compute_manager = compute_manager
        #: Possibly-distinct manager for task execution states (paper §4.3,
        #: Tasking frontend: scheduling on CPU, tasks on an accelerator).
        self.task_compute_manager = task_compute_manager or compute_manager

    def query_full_topology(self) -> Topology:
        topo = Topology()
        for tm in self.topology_managers:
            topo = topo.merge(tm.query_topology())
        return topo
