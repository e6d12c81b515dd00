"""SPMD backend: HiCR over `torch.distributed`. Port of
`repro/backends/spmd.py`.

One process a device, all running the same program (`torchrun`, or any
launcher that sets the process group up): NCCL on the card, gloo across
CPU processes, the ``fake`` group for a dry run. A `DeviceMesh` with named
dims takes the place of the reference's JAX `Mesh`, DTensor placements the
place of its `NamedSharding`s. HiCR's communication semantics come at two
levels:

* **host level** — `reshard` = moving a tensor between placements
  (`distribute_tensor` / `redistribute`), `fence` = draining the pending
  transfers (a CUDA event recorded after each); local↔global maps to
  replicated↔sharded placement changes. `memcpy` is local to local only.
* **collectives over one mesh dim's process group** — the vocabulary the
  models' distribution uses (`all_reduce`, `all_gather`, `reduce_scatter`,
  `all_to_all`, `ppermute_halo`), with the reference's `shard_map`
  semantics. Every collective is issued by the participating program
  itself (the model's G2G prohibition holds).

The compute manager's execution units are callables run under the mesh
(and `sharding.ambient.active_mesh`); a processing unit is an initialised
mesh slice (``ComputeResourceKind.MESH_SLICE``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.definitions import (
    ComputeResourceKind,
    InvalidMemcpyDirectionError,
    LifetimeError,
    MemcpyDirection,
    ProcessingUnitStatus,
    UnsupportedOperationError,
)
from repro_torch.core.events import Future
from repro_torch.core.managers import CommunicationManager, ComputeManager, InstanceManager
from repro_torch.core.stateful import ExecutionState, Instance, ProcessingUnit
from repro_torch.core.stateless import ComputeResource, ExecutionUnit

from .torchdev import _byte_view, _stream_event


def _dist():
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("spmd: no default process group; call "
                           "torch.distributed.init_process_group first")
    return dist


class SpmdInstanceManager(InstanceManager):
    """Instances = the ranks of the default process group (the launch-time
    detection path of §3.1.1); rank 0 is root. Creating instances at run
    time needs a cluster control plane and is left to deployment tooling,
    as in the reference (the localsim backend models that path)."""

    backend_name = "spmd"

    def __init__(self):
        dist = _dist()
        n, me = dist.get_world_size(), dist.get_rank()
        self._instances = tuple(Instance(f"proc-{i}", is_root=(i == 0)) for i in range(n))
        self._current = self._instances[me]

    def get_instances(self) -> Sequence[Instance]:
        return self._instances

    def get_current_instance(self) -> Instance:
        return self._current


class SpmdCommunicationManager(CommunicationManager):
    """Host-level resharding over `mesh`, and the collectives over one of
    its dims' process groups (`axis_name`)."""

    backend_name = "spmd"

    def __init__(self, mesh=None):
        self.mesh = mesh

    # -- host level -----------------------------------------------------------
    def reshard(self, tensor: torch.Tensor, placements, *, mesh=None, tag: int = 0):
        """The L2G/G2L analog at runtime level: move a tensor between
        placements (a plain tensor is distributed from this rank's copy, a
        DTensor redistributed). Asynchronous on CUDA: fence(tag) drains it
        (the transfer joins `tag`'s event set exactly like a memcpy)."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        mesh = mesh or self.mesh
        if isinstance(tensor, DTensor):
            out = tensor.redistribute(mesh, placements)
        else:
            out = distribute_tensor(tensor, mesh, placements)
        self._record_transfer(tag, _stream_event(out.to_local().device, name="spmd-reshard"))
        return out

    def _memcpy_impl(self, direction, dst, dst_off, src, src_off, size):
        if direction != MemcpyDirection.LOCAL_TO_LOCAL:
            raise InvalidMemcpyDirectionError(
                "spmd memcpy between instances is expressed as resharding "
                "(use .reshard) or collectives"
            )
        dst.check_alive()
        src.check_alive()
        if dst_off + size > dst.size_bytes or src_off + size > src.size_bytes:
            raise ValueError("memcpy out of slot bounds")
        d, s = _byte_view(dst.handle), _byte_view(src.handle)
        d0, s0 = dst.offset + dst_off, src.offset + src_off
        d[d0:d0 + size].copy_(s[s0:s0 + size], non_blocking=True)
        return _stream_event(d.device, name="spmd-memcpy")

    def exchange_global_memory_slots(self, tag, local_slots):
        raise UnsupportedOperationError(
            "spmd global slots are DTensor placements established by the program"
        )

    # -- collectives over one mesh dim ---------------------------------------
    def group(self, axis_name: str):
        return self.mesh.get_group(axis_name)

    def all_reduce(self, x: torch.Tensor, axis_name: str) -> torch.Tensor:
        """Sum over the ranks of `axis_name` (the reference's `psum`)."""
        import torch.distributed._functional_collectives as fc

        return fc.wait_tensor(fc.all_reduce(x, "sum", self.group(axis_name)))

    def all_gather(self, x: torch.Tensor, axis_name: str, *, axis: int = 0,
                   tiled: bool = True) -> torch.Tensor:
        """The ranks' tensors concatenated along `axis` in rank order
        (``tiled``), else stacked in a new leading-at-`axis` dim."""
        import torch.distributed._functional_collectives as fc

        group = self.group(axis_name)
        n = _dist().get_world_size(group)
        out = fc.wait_tensor(fc.all_gather_tensor(x.contiguous().reshape(1, *x.shape), 0, group))
        parts = out.reshape((n,) + tuple(x.shape))
        if not tiled:
            return parts.movedim(0, axis)
        return torch.cat(list(parts.unbind(0)), dim=axis)

    def reduce_scatter(self, x: torch.Tensor, axis_name: str, *,
                       scatter_dimension: int = 0) -> torch.Tensor:
        """The sum over the ranks, this rank's block along
        `scatter_dimension` (the reference's tiled `psum_scatter`)."""
        import torch.distributed._functional_collectives as fc

        moved = x.movedim(scatter_dimension, 0).contiguous()
        out = fc.wait_tensor(fc.reduce_scatter_tensor(moved, "sum", 0, self.group(axis_name)))
        return out.movedim(0, scatter_dimension)

    def all_to_all(self, x: torch.Tensor, axis_name: str, *, split_axis: int,
                   concat_axis: int, tiled: bool = True) -> torch.Tensor:
        """Block j of `x` along `split_axis` goes to rank j; the blocks
        received are concatenated along `concat_axis` in source-rank order."""
        group = self.group(axis_name)
        dist = _dist()
        n = dist.get_world_size(group)
        blocks = torch.stack(torch.chunk(x, n, dim=split_axis))  # (n, *block): block j to rank j
        received = torch.empty_like(blocks)
        if n == 1:
            received.copy_(blocks)
        else:
            dist.all_to_all_single(received, blocks, group=group)
        return torch.cat(list(received.unbind(0)), dim=concat_axis)

    def ppermute_halo(self, x: torch.Tensor, axis_name: str, *, shift: int = 1) -> torch.Tensor:
        """Neighbour exchange on a ring (the Jacobi halo pattern): rank i's
        tensor goes to rank (i + shift) mod n of `axis_name`."""
        group = self.group(axis_name)
        dist = _dist()
        n, me = dist.get_world_size(group), dist.get_rank(group)
        if n == 1 or shift % n == 0:
            return x.clone()
        to = dist.get_global_rank(group, (me + shift) % n)
        frm = dist.get_global_rank(group, (me - shift) % n)
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x.contiguous(), to, group),
               dist.P2POp(dist.irecv, out, frm, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


class SpmdComputeManager(ComputeManager):
    """Execution units are SPMD programs over a mesh; a processing unit is an
    initialised mesh context; dispatch is asynchronous on CUDA."""

    backend_name = "spmd"
    supported_formats = ("torch-spmd", "torch-eager", "python-callable")
    supports_suspension = False

    def __init__(self, mesh=None):
        self.mesh = mesh

    def mesh_compute_resource(self) -> ComputeResource:
        assert self.mesh is not None
        return ComputeResource(
            kind=ComputeResourceKind.MESH_SLICE.value,
            index=0,
            device_id=f"mesh-{'x'.join(map(str, self.mesh.mesh.shape))}",
            attributes={"axis_names": tuple(self.mesh.mesh_dim_names),
                        "device_type": self.mesh.device_type},
        )

    def create_execution_unit(self, fn, *, name: str = "spmd-program", **metadata) -> ExecutionUnit:
        return ExecutionUnit(name=name, format="torch-spmd", fn=fn, metadata=metadata)

    def create_processing_unit(self, resource: ComputeResource) -> ProcessingUnit:
        return ProcessingUnit(resource)

    def create_execution_state(self, unit: ExecutionUnit, *args, **kwargs) -> ExecutionState:
        self.check_format(unit)
        return ExecutionState(unit, args, kwargs)

    def initialize(self, pu: ProcessingUnit) -> None:
        pu.context = self.mesh
        pu.status = ProcessingUnitStatus.READY

    def _device(self) -> torch.device:
        if self.mesh is not None and self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def execute(self, pu: ProcessingUnit, state: ExecutionState) -> Future:
        pu.check_ready()
        if state.is_finished():
            raise LifetimeError("finished execution states cannot be re-used")
        state.mark_executing()
        pu.current_state = state
        pu.status = ProcessingUnitStatus.EXECUTING
        try:
            if self.mesh is not None:
                from repro_torch.sharding.ambient import active_mesh

                with active_mesh(self.mesh):
                    result = state.execution_unit.fn(*state.args, **state.kwargs)
            else:
                result = state.execution_unit.fn(*state.args, **state.kwargs)
        except BaseException as e:  # noqa: BLE001 - surfaced through the Future
            state.mark_finished(error=e)
            pu.status = ProcessingUnitStatus.READY
            return state.future
        pu.status = ProcessingUnitStatus.READY
        done = _stream_event(self._device(), name=f"spmd-exec:{state.execution_unit.name}")
        if done.done():
            state.mark_finished(result=result)
            return state.future
        # Completion is discovered, not signalled: poll the CUDA event
        state.continuation = (done, result)
        state.future.set_poll(lambda: self._poll_finished(state))
        state.future.set_waiter(lambda: self._resolve(state))
        return state.future

    def _poll_finished(self, state: ExecutionState) -> bool:
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
        except BaseException as e:  # noqa: BLE001
            state.mark_finished(error=e)

    def finalize(self, pu: ProcessingUnit) -> None:
        pu.status = ProcessingUnitStatus.TERMINATED
        pu.current_state = None
