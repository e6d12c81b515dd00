"""PyTorch-device backend: the port's counterpart of the reference's `jaxdev`
(the ACL / OpenCL analog of paper §4.2).

A backend instance is bound to ONE torch device. With no device given it
binds to the current CUDA device and raises when there is none: the CPU is
used only when the caller asks for it (``device="cpu"``, as the tests do).

* Topology comes from `torch.cuda.get_device_properties` (SM count, device
  memory); a CPU binding exposes one host compute resource.
* Memory slots are torch tensors. Tensors are mutable, so a local-to-local
  memcpy is a real in-place `copy_` of a byte range on the current stream
  (jaxdev rebinds an immutable array instead).
* Execution units are plain Python callables run eagerly: PyTorch enqueues
  their kernels on the current stream and returns. `execute()` records a
  `torch.cuda.Event` after the launch; the returned Future polls that event
  and resolves through its blocking `synchronize()` on an untimed wait.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.core.definitions import (
    ComputeResourceKind,
    InvalidMemcpyDirectionError,
    LifetimeError,
    MemcpyDirection,
    MemorySpaceKind,
    ProcessingUnitStatus,
    UnsupportedOperationError,
)
from repro_torch.core.events import Event, completed_event
from repro_torch.core.managers import (
    CommunicationManager,
    ComputeManager,
    MemoryManager,
    TopologyManager,
)
from repro_torch.core.stateful import ExecutionState, LocalMemorySlot, ProcessingUnit
from repro_torch.core.stateless import (
    ComputeResource,
    Device,
    ExecutionUnit,
    MemorySpace,
    Topology,
)


def resolve_device(device: Optional[Any] = None) -> torch.device:
    """The torch device a torchdev manager binds to. None means the current
    CUDA device; there is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "torchdev: no CUDA device is available; pass device='cpu' to "
                "run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"torchdev: device {device!r} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"torchdev: unsupported device {device!r} (cuda or cpu)")
    return dev


def _device_id(dev: torch.device) -> str:
    return f"torch-{dev.type}-{dev.index or 0}"


def _device_of(space_or_resource) -> torch.device:
    kind, index = space_or_resource.device_id.split("-")[1:]
    return torch.device(kind, int(index)) if kind == "cuda" else torch.device("cpu")


class TorchTopologyManager(TopologyManager):
    backend_name = "torchdev"

    def __init__(self, device: Optional[Any] = None):
        self.device = resolve_device(device)

    def query_topology(self) -> Topology:
        dev = self.device
        dev_id = _device_id(dev)
        if dev.type == "cuda":
            props = torch.cuda.get_device_properties(dev)
            attrs = {
                "platform": "gpu",
                "name": props.name,
                "sm_count": props.multi_processor_count,
                "capability": f"{props.major}.{props.minor}",
            }
            cr = ComputeResource(
                kind=ComputeResourceKind.ACCELERATOR_STREAM.value,
                index=dev.index,
                device_id=dev_id,
                attributes=attrs,
            )
            ms = MemorySpace(
                kind=MemorySpaceKind.DEVICE_HBM.value,
                index=dev.index,
                device_id=dev_id,
                size_bytes=int(props.total_memory),
            )
            kind = "gpu"
        else:
            attrs = {"platform": "cpu", "threads": torch.get_num_threads()}
            cr = ComputeResource(
                kind=ComputeResourceKind.CPU_CORE.value, index=0,
                device_id=dev_id, attributes=attrs,
            )
            ms = MemorySpace(
                kind=MemorySpaceKind.HOST_RAM.value, index=0, device_id=dev_id,
                size_bytes=_host_memory_bytes(),
            )
            kind = "cpu"
        device = Device(
            device_id=dev_id,
            kind=kind,
            compute_resources=(cr,),
            memory_spaces=(ms,),
            attributes={"torch_device": str(dev)},
        )
        return Topology(devices=(device,))


def _host_memory_bytes() -> int:
    import os

    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return 0


class TorchMemoryManager(MemoryManager):
    backend_name = "torchdev"

    def __init__(self, device: Optional[Any] = None):
        self._spaces = tuple(TorchTopologyManager(device).query_topology().all_memory_spaces())

    def memory_spaces(self) -> Sequence[MemorySpace]:
        return self._spaces

    def allocate_local_memory_slot(self, space: MemorySpace, size_bytes: int) -> LocalMemorySlot:
        self._check_space(space)
        if size_bytes <= 0:
            raise ValueError("allocation size must be positive")
        buf = torch.zeros((size_bytes,), dtype=torch.uint8, device=_device_of(space))
        return LocalMemorySlot(space, size_bytes, buf)

    def register_local_memory_slot(self, space: MemorySpace, buffer: Any, size_bytes: int) -> LocalMemorySlot:
        self._check_space(space)
        if isinstance(buffer, torch.Tensor):
            if buffer.device != _device_of(space):
                raise ValueError(
                    f"tensor on {buffer.device} cannot be registered in {space.device_id}"
                )
            tensor = buffer
        else:
            host = torch.frombuffer(bytearray(bytes(buffer)[:size_bytes]), dtype=torch.uint8)
            tensor = host.to(_device_of(space))
        return LocalMemorySlot(space, size_bytes, tensor, registered=True)

    def free_local_memory_slot(self, slot: LocalMemorySlot) -> None:
        slot.check_alive()
        slot.handle = None
        slot.freed = True


def _byte_view(tensor: torch.Tensor) -> torch.Tensor:
    if not tensor.is_contiguous():
        raise ValueError("memcpy needs contiguous tensors")
    return tensor.reshape(-1).view(torch.uint8)


def _stream_event(device: torch.device, *, name: str) -> Event:
    """Completion of the work enqueued so far on `device`'s current stream:
    poll = `torch.cuda.Event.query()`, untimed wait = `synchronize()`. CPU
    work is complete when it returns."""
    if device.type != "cuda":
        return completed_event(name=name)
    marker = torch.cuda.Event()
    marker.record(torch.cuda.current_stream(device))
    event = Event(name=name)
    event.set_poll(marker.query)
    event.set_waiter(marker.synchronize)
    return event


class TorchCommunicationManager(CommunicationManager):
    """Local-to-local copies between tensor slots, in place, asynchronous
    on CUDA (the transfer Event polls a CUDA event recorded after the copy)."""

    backend_name = "torchdev"

    def __init__(self, device: Optional[Any] = None):
        self.device = resolve_device(device)

    def _memcpy_impl(self, direction, dst, dst_off, src, src_off, size):
        if direction != MemcpyDirection.LOCAL_TO_LOCAL:
            raise InvalidMemcpyDirectionError("torchdev communication is intra-instance")
        dst.check_alive()
        src.check_alive()
        if dst_off + size > dst.size_bytes or src_off + size > src.size_bytes:
            raise ValueError("memcpy out of slot bounds")
        d = _byte_view(dst.handle)
        s = _byte_view(src.handle)
        d0, s0 = dst.offset + dst_off, src.offset + src_off
        # in place: the destination tensor's bytes change, no rebinding
        d[d0 : d0 + size].copy_(s[s0 : s0 + size], non_blocking=True)
        return _stream_event(d.device, name="torchdev-memcpy")

    def exchange_global_memory_slots(self, tag, local_slots):
        raise UnsupportedOperationError("torchdev is intra-instance")


class TorchComputeManager(ComputeManager):
    """Execution units are eager Python callables over tensors; execution
    states are their enqueued launches; processing units are devices."""

    backend_name = "torchdev"
    supported_formats = ("torch-eager", "python-callable")
    supports_suspension = False

    def __init__(self, device: Optional[Any] = None):
        self.device = resolve_device(device)

    def create_execution_unit(self, fn, *, name: str = "anonymous", **metadata) -> ExecutionUnit:
        return ExecutionUnit(name=name, format="torch-eager", fn=fn, metadata=metadata)

    def create_processing_unit(self, resource: ComputeResource) -> ProcessingUnit:
        return ProcessingUnit(resource)

    def create_execution_state(self, unit: ExecutionUnit, *args, **kwargs) -> ExecutionState:
        self.check_format(unit)
        return ExecutionState(unit, args, kwargs)

    def initialize(self, pu: ProcessingUnit) -> None:
        pu.context = _device_of(pu.compute_resource)
        pu.status = ProcessingUnitStatus.READY

    def execute(self, pu: ProcessingUnit, state: ExecutionState):
        pu.check_ready()
        if state.is_finished():
            raise LifetimeError("finished execution states cannot be re-used")
        state.mark_executing()
        pu.current_state = state
        pu.status = ProcessingUnitStatus.EXECUTING
        dev = pu.context
        try:
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    result = state.execution_unit.fn(*state.args, **state.kwargs)
            else:
                result = state.execution_unit.fn(*state.args, **state.kwargs)
        except BaseException as e:  # noqa: BLE001 - surfaced through the Future
            state.mark_finished(error=e)
            pu.status = ProcessingUnitStatus.READY
            return state.future
        pu.status = ProcessingUnitStatus.READY
        done = _stream_event(dev, name=f"torchdev-exec:{state.execution_unit.name}")
        if done.done():
            state.mark_finished(result=result)
            return state.future
        # Completion is discovered, not signalled: poll the CUDA event, and
        # resolve through its blocking synchronize on an untimed wait.
        state.continuation = (done, result)
        state.future.set_poll(lambda: self.is_finished(state))
        state.future.set_waiter(lambda: self._resolve(state))
        return state.future

    def is_finished(self, state: ExecutionState) -> bool:
        """Non-blocking completion query (paper §3.1.5)."""
        if state.is_finished():
            return True
        done, result = state.continuation
        if done.done():
            state.mark_finished(result=result)
            return True
        return False

    def _resolve(self, state: ExecutionState) -> None:
        if state.is_finished():
            return
        done, result = state.continuation
        try:
            done.wait()
            state.mark_finished(result=result)
        except BaseException as e:  # noqa: BLE001 - surfaced through the Future
            state.mark_finished(error=e)

    def finalize(self, pu: ProcessingUnit) -> None:
        pu.status = ProcessingUnitStatus.TERMINATED
        pu.current_state = None
