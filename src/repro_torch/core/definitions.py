"""Core definitions for the HiCR model.

The HiCR model (Martin et al., 2025) divides components into three groups:

* **Managers** — effectful components; the only components allowed to create
  instances of other components (stateless and stateful alike).
* **Stateless** — static, copyable, serializable descriptions (topology
  information, execution-unit descriptions, instance templates).
* **Stateful** — unique objects with a finite lifetime and mutating internal
  state (instances, processing units, execution states, memory slots).

This module holds shared enums, identifiers and errors used across the
component groups.
"""
from __future__ import annotations

import enum
import itertools
import threading


class HiCRError(RuntimeError):
    """Base error for violations of the HiCR model semantics."""


class UnsupportedOperationError(HiCRError):
    """A backend was asked to perform an operation outside its capability set."""


class InvalidMemcpyDirectionError(HiCRError):
    """memcpy was requested in a direction the model forbids (Global-to-Global)."""


class MemorySpaceMismatchError(HiCRError):
    """A manager does not recognize / cannot operate on a given memory space."""


class LifetimeError(HiCRError):
    """A stateful component was used outside its legal lifecycle."""


class FutureTimeoutError(HiCRError, TimeoutError):
    """A completion object (Event/Future) did not complete within the
    requested timeout. Also a TimeoutError so pre-Future callers that catch
    the builtin keep working."""


class NoRootInstanceError(HiCRError):
    """No launched instance is designated root (paper §3.1.1 tie-breaking)."""


class RemoteCallError(HiCRError):
    """An RPC executed on the remote instance raised; carries its repr."""


class InstanceFailedError(HiCRError):
    """An instance's entry function raised instead of returning."""


class ExecutionStateStatus(enum.Enum):
    """Lifecycle of an ExecutionState (paper §3.1.5)."""

    CREATED = "created"
    READY = "ready"
    EXECUTING = "executing"
    SUSPENDED = "suspended"
    FINISHED = "finished"


class ProcessingUnitStatus(enum.Enum):
    """Lifecycle of a ProcessingUnit (paper §3.1.5)."""

    UNINITIALIZED = "uninitialized"
    READY = "ready"
    EXECUTING = "executing"
    SUSPENDED = "suspended"
    TERMINATED = "terminated"


class InstanceStatus(enum.Enum):
    RUNNING = "running"
    TERMINATED = "terminated"
    #: The instance's entry function raised instead of returning — the
    #: liveness signal a fleet router distinguishes from a clean terminate.
    FAILED = "failed"


class MemcpyDirection(enum.Enum):
    """The three legal memcpy directions (paper §3.1.4)."""

    LOCAL_TO_LOCAL = "l2l"
    LOCAL_TO_GLOBAL = "l2g"
    GLOBAL_TO_LOCAL = "g2l"


class ComputeResourceKind(enum.Enum):
    CPU_CORE = "cpu_core"
    TPU_TENSORCORE = "tpu_tensorcore"
    TPU_SPARSECORE = "tpu_sparsecore"
    ACCELERATOR_STREAM = "accelerator_stream"
    MESH_SLICE = "mesh_slice"


class MemorySpaceKind(enum.Enum):
    HOST_RAM = "host_ram"
    NUMA_DOMAIN = "numa_domain"
    DEVICE_HBM = "device_hbm"
    DEVICE_VMEM = "device_vmem"


_id_counter = itertools.count()
_id_lock = threading.Lock()


def fresh_id(prefix: str) -> str:
    """Process-unique id for stateful components (which cannot be replicated)."""
    with _id_lock:
        return f"{prefix}-{next(_id_counter)}"
