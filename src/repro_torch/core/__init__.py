# The paper's primary contribution: the HiCR abstract model — a Runtime
# Support Layer between applications/runtime-systems and system technologies.
from .definitions import (
    ExecutionStateStatus,
    FutureTimeoutError,
    HiCRError,
    InstanceFailedError,
    InstanceStatus,
    InvalidMemcpyDirectionError,
    LifetimeError,
    MemcpyDirection,
    MemorySpaceMismatchError,
    NoRootInstanceError,
    ProcessingUnitStatus,
    RemoteCallError,
    UnsupportedOperationError,
)
from .events import (
    Event,
    Future,
    completed_event,
    completed_future,
    failed_future,
    wait_all,
    wait_any,
)
from .managers import (
    CommunicationManager,
    ComputeManager,
    InstanceManager,
    ManagerSet,
    MemoryManager,
    TopologyManager,
)
from .registry import (
    available_backends,
    build,
    capability_table,
    get_backend,
    register_backend,
)
from .runtime import Runtime, RuntimeAssemblyError
from .stateful import (
    ExecutionState,
    GlobalMemorySlot,
    Instance,
    LocalMemorySlot,
    ProcessingUnit,
)
from .stateless import (
    ComputeResource,
    Device,
    ExecutionUnit,
    InstanceTemplate,
    MemorySpace,
    Topology,
)

__all__ = [
    "CommunicationManager", "ComputeManager", "ComputeResource", "Device",
    "Event", "ExecutionState", "ExecutionStateStatus", "ExecutionUnit",
    "Future", "FutureTimeoutError", "GlobalMemorySlot", "HiCRError",
    "Instance", "InstanceFailedError", "InstanceManager", "InstanceStatus",
    "InstanceTemplate", "InvalidMemcpyDirectionError", "LifetimeError",
    "LocalMemorySlot", "ManagerSet", "MemcpyDirection", "MemoryManager",
    "MemorySpace", "MemorySpaceMismatchError", "NoRootInstanceError",
    "ProcessingUnit", "ProcessingUnitStatus", "RemoteCallError", "Runtime",
    "RuntimeAssemblyError", "Topology", "TopologyManager",
    "UnsupportedOperationError", "available_backends", "build",
    "capability_table", "completed_event", "completed_future",
    "failed_future", "get_backend", "register_backend", "wait_all",
    "wait_any",
]
