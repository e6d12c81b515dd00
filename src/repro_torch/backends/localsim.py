"""Local distributed-simulation backend: the MPI / LPF analog (paper §4.2).

Runs N HiCR *instances* as threads inside one process, connected by an
in-process **fabric** that provides one-sided put/get on exchanged global
memory slots, per-tag fencing, collective slot exchange, and a message path
for the RPC frontend.

Two communication personalities are provided, mirroring the paper's Fig. 8
comparison:

* ``mode="rdma"`` (LPF/zero-engine analog) — the origin-side NIC thread
  writes directly into the target buffer and bumps a completion counter;
  no per-message handshake (hardware completion-queue style).
* ``mode="rendezvous"`` (MPI one-sided analog) — every transfer performs a
  request/ack round-trip with the target NIC thread before the data is
  moved, modeling the heavier handshaking of portable one-sided MPI.

Both personalities execute the *same* HiCR program; only the backend differs
— that is the paper's point.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.definitions import (
    HiCRError,
    InstanceFailedError,
    InvalidMemcpyDirectionError,
    MemcpyDirection,
    UnsupportedOperationError,
)
from repro_torch.core.events import Event
from repro_torch.core.managers import (
    CommunicationManager,
    InstanceManager,
    ManagerSet,
)
from repro_torch.core.stateful import GlobalMemorySlot, Instance, LocalMemorySlot
from repro_torch.core.stateless import InstanceTemplate, Topology

from . import hostcpu


class _DynamicBarrier:
    """A reusable barrier whose party count is read at entry time, so
    elastically-created instances can join later collectives."""

    def __init__(self, world):
        self._world = world
        self._cv = threading.Condition()
        self._count = 0
        self._generation = 0

    def wait(self):
        with self._cv:
            gen = self._generation
            self._count += 1
            if self._count >= self._world.size():
                self._count = 0
                self._generation += 1
                self._cv.notify_all()
                return
            self._cv.wait_for(lambda: self._generation != gen)


class Fabric:
    """In-process interconnect: registered global slots + one-sided put/get
    executed by per-rank NIC threads, with per-(rank, tag) completion
    counters backing ``fence``."""

    def __init__(self, world, *, mode: str = "rdma"):
        assert mode in ("rdma", "rendezvous")
        self.world = world
        self.mode = mode
        self._slots: Dict[Tuple[int, int], Tuple[int, np.ndarray, int]] = {}
        self._slot_lock = threading.RLock()
        self._exchange_cv = threading.Condition()
        self._exchange_box: Dict[int, Dict[int, Tuple[int, Optional[LocalMemorySlot]]]] = {}
        self._barrier = _DynamicBarrier(world)
        self._pending_cv = threading.Condition()
        self._pending: Dict[Tuple[int, int], int] = {}
        self._nics: Dict[int, "queue.Queue[tuple | None]"] = {}
        self._nic_threads: Dict[int, threading.Thread] = {}
        self._tag_locks: Dict[int, threading.Lock] = {}
        self._msg_queues: Dict[int, "queue.Queue[bytes]"] = {}

    # -- rank lifecycle ------------------------------------------------------
    def attach_rank(self, rank: int):
        q: "queue.Queue[tuple | None]" = queue.Queue()
        self._nics[rank] = q
        t = threading.Thread(target=self._nic_loop, args=(rank, q), daemon=True, name=f"nic-{rank}")
        self._nic_threads[rank] = t
        self._msg_queues[rank] = queue.Queue()
        t.start()

    def detach_rank(self, rank: int):
        q = self._nics.get(rank)
        if q is not None:
            q.put(None)
            self._nic_threads[rank].join(timeout=5)

    # -- NIC ------------------------------------------------------------------
    def _nic_loop(self, rank: int, q: "queue.Queue[tuple | None]"):
        while True:
            op = q.get()
            if op is None:
                return
            kind = op[0]
            if kind == "ack":
                # rendezvous reply: wake the waiting origin NIC
                op[1].set()
                continue
            if kind == "rts":
                # target side of a rendezvous: acknowledge readiness
                _, origin_rank, event = op
                event.set()
                continue
            if kind in ("put", "get"):
                (_, tag, key, local_slot, local_off, remote_off, size, origin, event) = op
                if self.mode == "rendezvous":
                    owner = self._slots[(tag, key)][0]
                    if owner != origin:
                        ev = threading.Event()
                        self._nics[owner].put(("rts", origin, ev))
                        # While waiting for the target's ready-to-send ack we
                        # MUST keep serving handshakes addressed to us, or two
                        # NICs putting to each other deadlock symmetrically.
                        # Data ops that arrive meanwhile are deferred (HiCR
                        # guarantees completion only at the fence, not order).
                        while not ev.is_set():
                            try:
                                other = q.get(timeout=0.001)
                            except queue.Empty:
                                continue
                            if other is None:
                                q.put(None)  # re-post shutdown for after this op
                                break
                            if other[0] in ("rts", "ack"):
                                (other[2] if other[0] == "rts" else other[1]).set()
                            else:
                                q.put(other)  # defer until handshake completes
                with self._slot_lock:
                    owner, remote_view, remote_size = self._slots[(tag, key)]
                    if remote_off + size > remote_size:
                        self._complete(origin, tag, event, error=True)
                        continue
                    lview = local_slot.handle.view(np.uint8).reshape(-1)
                    lo = local_slot.offset + local_off
                    if kind == "put":
                        remote_view[remote_off : remote_off + size] = lview[lo : lo + size]
                    else:
                        lview[lo : lo + size] = remote_view[remote_off : remote_off + size]
                self._complete(origin, tag, event)

    def _complete(self, rank: int, tag: int, event: "Event", error: bool = False):
        with self._pending_cv:
            self._pending[(rank, tag)] -= 1
            self._pending_cv.notify_all()
        event.set()  # the NIC thread signals the transfer's completion object

    # -- one-sided operations --------------------------------------------------
    def enqueue(self, kind: str, origin: int, tag: int, key: int, local_slot, local_off, remote_off, size) -> "Event":
        if (tag, key) not in self._slots:
            raise HiCRError(f"no global slot registered for (tag={tag}, key={key})")
        with self._pending_cv:
            self._pending[(origin, tag)] = self._pending.get((origin, tag), 0) + 1
        event = Event(name=f"fabric-{kind}-t{tag}k{key}")
        self._nics[origin].put((kind, tag, key, local_slot, local_off, remote_off, size, origin, event))
        return event

    def fence(self, rank: int, tag: int):
        with self._pending_cv:
            self._pending_cv.wait_for(lambda: self._pending.get((rank, tag), 0) == 0)

    # -- collective exchange -----------------------------------------------------
    _POISON = object()  # marks a duplicate-key violation inside an exchange

    def exchange(self, rank: int, tag: int, local_slots: Mapping[int, LocalMemorySlot]):
        """Collective: merge everyone's (key -> slot) contributions for `tag`.

        A duplicate (tag, key) pair poisons the WHOLE collective: every
        participant raises after the barrier (raising on one rank only
        would leave the others stuck in the barrier)."""
        with self._exchange_cv:
            box = self._exchange_box.setdefault(tag, {})
            for key, slot in local_slots.items():
                if key in box:
                    box[Fabric._POISON] = (rank, key)
                else:
                    box[key] = (rank, slot)
        self._barrier.wait()
        with self._exchange_cv:
            box = self._exchange_box.get(tag, {})
            poison = box.get(Fabric._POISON)
            if poison is None:
                with self._slot_lock:
                    for key, (owner, slot) in box.items():
                        view = slot.handle.view(np.uint8).reshape(-1)[slot.offset : slot.offset + slot.size_bytes]
                        self._slots[(tag, key)] = (owner, view, slot.size_bytes)
                result = dict(box)
        self._barrier.wait()
        if rank == 0:
            with self._exchange_cv:
                self._exchange_box.pop(tag, None)
        if poison is not None:
            raise HiCRError(
                f"duplicate key {poison[1]} in exchange tag {tag} (from rank {poison[0]})"
            )
        return result

    def register_direct(self, rank: int, tag: int, key: int, slot: LocalMemorySlot):
        """Non-collective registration (DataObject publish path): make a local
        slot remotely reachable without a collective exchange."""
        with self._slot_lock:
            if (tag, key) in self._slots:
                raise HiCRError(f"(tag={tag}, key={key}) already registered")
            view = slot.handle.view(np.uint8).reshape(-1)[slot.offset : slot.offset + slot.size_bytes]
            self._slots[(tag, key)] = (rank, view, slot.size_bytes)

    def deregister(self, tag: int, key: int):
        with self._slot_lock:
            self._slots.pop((tag, key), None)

    def lookup(self, tag: int, key: int):
        with self._slot_lock:
            entry = self._slots.get((tag, key))
        if entry is None:
            raise HiCRError(f"no global slot for (tag={tag}, key={key})")
        return entry

    # -- global locks (MPSC locking channels) -------------------------------------
    def acquire_lock(self, tag: int):
        self._tag_locks.setdefault(tag, threading.Lock()).acquire()

    def release_lock(self, tag: int):
        self._tag_locks[tag].release()

    # -- messages (RPC path) --------------------------------------------------------
    def send_message(self, dst_rank: int, payload: bytes):
        self._msg_queues[dst_rank].put(payload)

    def recv_message(self, rank: int, timeout: float | None = None) -> Optional[bytes]:
        try:
            return self._msg_queues[rank].get(timeout=timeout)
        except queue.Empty:
            return None


class LocalSimCommunicationManager(CommunicationManager):
    """One-sided put/get + per-tag fence over the in-process fabric."""

    backend_name = "localsim"

    def __init__(self, fabric: Fabric, rank: int, instance_id: str):
        self.fabric = fabric
        self.rank = rank
        self.instance_id = instance_id

    def _memcpy_impl(self, direction, dst, dst_off, src, src_off, size):
        if direction == MemcpyDirection.LOCAL_TO_LOCAL:
            dview = dst.handle.view(np.uint8).reshape(-1)
            sview = src.handle.view(np.uint8).reshape(-1)
            dview[dst.offset + dst_off : dst.offset + dst_off + size] = sview[
                src.offset + src_off : src.offset + src_off + size
            ]
            return None  # synchronous host copy
        if direction == MemcpyDirection.LOCAL_TO_GLOBAL:
            # one-sided PUT into (possibly remote) global slot
            return self.fabric.enqueue("put", self.rank, dst.tag, dst.key, src, src_off, dst_off, size)
        if direction == MemcpyDirection.GLOBAL_TO_LOCAL:
            # one-sided GET from (possibly remote) global slot
            return self.fabric.enqueue("get", self.rank, src.tag, src.key, dst, dst_off, src_off, size)
        raise InvalidMemcpyDirectionError(str(direction))  # pragma: no cover

    def exchange_global_memory_slots(self, tag, local_slots):
        merged = self.fabric.exchange(self.rank, tag, local_slots)
        out: Dict[int, GlobalMemorySlot] = {}
        for key, (owner, slot) in merged.items():
            out[key] = GlobalMemorySlot(
                tag=tag,
                key=key,
                owner_instance_id=f"inst-{owner}",
                local_slot=slot if owner == self.rank else None,
                size_bytes=slot.size_bytes,
                fabric_handle=owner,
            )
        return out

    # -- extension ops used by the Channels frontend (MPSC locking mode) ------
    def acquire_global_lock(self, tag: int):
        self.fabric.acquire_lock(tag)

    def release_global_lock(self, tag: int):
        self.fabric.release_lock(tag)

    # -- extension ops used by the DataObject frontend -------------------------
    def register_global_slot(self, tag: int, key: int, slot: LocalMemorySlot) -> GlobalMemorySlot:
        self.fabric.register_direct(self.rank, tag, key, slot)
        return GlobalMemorySlot(
            tag=tag, key=key, owner_instance_id=self.instance_id,
            local_slot=slot, size_bytes=slot.size_bytes, fabric_handle=self.rank,
        )

    def get_global_slot_handle(self, tag: int, key: int) -> GlobalMemorySlot:
        owner, _view, size = self.fabric.lookup(tag, key)
        return GlobalMemorySlot(
            tag=tag, key=key, owner_instance_id=f"inst-{owner}",
            local_slot=None, size_bytes=size, fabric_handle=owner,
        )

    def destroy_global_memory_slot(self, slot: GlobalMemorySlot) -> None:
        self.fabric.deregister(slot.tag, slot.key)


class LocalSimInstanceManager(InstanceManager):
    backend_name = "localsim"

    def __init__(self, world: "LocalSimWorld", rank: int):
        self.world = world
        self.rank = rank

    def get_instances(self) -> Sequence[Instance]:
        return tuple(self.world.instances)

    def get_current_instance(self) -> Instance:
        return self.world.instances[self.rank]

    def create_instances(self, count: int, template: InstanceTemplate) -> Sequence[Instance]:
        return self.world.create_instances(count, template, creator_rank=self.rank)

    def terminate_instance(self, instance: Instance) -> None:
        instance.terminate()

    def send_message(self, instance: Instance, payload: bytes) -> None:
        rank = int(instance.instance_id.split("-")[1])
        self.world.fabric.send_message(rank, payload)

    def recv_message(self, timeout: float | None = None) -> Optional[bytes]:
        return self.world.fabric.recv_message(self.rank, timeout=timeout)


class LocalSimWorld:
    """A world of N thread-instances sharing a fabric.

    ``launch(fn)`` runs ``fn(managers: ManagerSet, rank: int)`` on every
    instance thread and returns the per-rank results. Instances created at
    runtime (elastic path) execute ``entry_fn`` as prescribed by their
    template metadata.
    """

    def __init__(self, n: int, *, mode: str = "rdma", entry_fn: Callable | None = None):
        self._size = n
        self._lock = threading.Lock()
        self.mode = mode
        self.fabric = Fabric(self, mode=mode)
        self.instances = [Instance(f"inst-{i}", is_root=(i == 0)) for i in range(n)]
        self.entry_fn = entry_fn
        self._threads: list[threading.Thread] = []
        self._results: Dict[int, Any] = {}
        self._errors: Dict[int, BaseException] = {}
        topo = hostcpu.HostTopologyManager().query_topology()
        for inst in self.instances:
            inst.topology = topo
        for i in range(n):
            self.fabric.attach_rank(i)

    def size(self) -> int:
        with self._lock:
            return self._size

    def managers_for(self, rank: int) -> ManagerSet:
        topo_mgr = hostcpu.HostTopologyManager()
        topo = topo_mgr.query_topology()
        return ManagerSet(
            instance_manager=LocalSimInstanceManager(self, rank),
            topology_managers=(topo_mgr,),
            memory_manager=hostcpu.HostMemoryManager(topo),
            communication_manager=LocalSimCommunicationManager(self.fabric, rank, f"inst-{rank}"),
            compute_manager=hostcpu.HostComputeManager(),
        )

    def _run_rank(self, fn: Callable, rank: int):
        try:
            self._results[rank] = fn(self.managers_for(rank), rank)
        except BaseException as e:  # noqa: BLE001
            self._errors[rank] = e
            # liveness signal for routers: a raised entry function ends the
            # instance as FAILED (a clean return leaves status untouched so
            # worlds can be re-launched over the same instances)
            self.instances[rank].mark_failed()

    def launch(self, fn: Callable, *, timeout: float = 120.0) -> Dict[int, Any]:
        launched = range(self._size)
        # a re-launch starts these ranks fresh: results/errors a caller
        # already handled (e.g. fleet workers whose failure was requeued)
        # must not leak into this launch's verdict
        for r in launched:
            self._errors.pop(r, None)
            self._results.pop(r, None)
        threads = [
            threading.Thread(target=self._run_rank, args=(fn, i), daemon=True, name=f"inst-{i}")
            for i in launched
        ]
        # keep a SEPARATE list for elastic threads to append to, so an
        # instance calling create_instances() mid-launch cannot mutate the
        # list we are iterating; still-running threads from an earlier
        # launch stay reachable for wait_instance()/join_elastic()
        self._threads = [t for t in self._threads if t.is_alive()] + list(threads)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
            if t.is_alive():
                raise TimeoutError(f"instance thread {t.name} did not finish in {timeout}s")
        # only the ranks THIS launch started are fatal here: an elastic
        # worker that failed and was handled (fleet requeue) is reported
        # through join_elastic()/instance_errors() instead
        own_errors = {r: e for r, e in self._errors.items() if r in launched}
        if own_errors:
            rank, err = sorted(own_errors.items())[0]
            raise InstanceFailedError(f"instance {rank} failed: {err!r}") from err
        return dict(self._results)

    # -- elastic instance creation (paper §3.1.1 / Fig. 7) ---------------------
    def create_instances(self, count: int, template: InstanceTemplate, *, creator_rank: int) -> Sequence[Instance]:
        if not self.instances[creator_rank].is_root():
            raise UnsupportedOperationError("only the root instance may create instances here")
        if self.entry_fn is None:
            raise UnsupportedOperationError("world has no entry_fn for elastic instances")
        created = []
        with self._lock:
            base = self._size
            self._size += count
        for j in range(count):
            rank = base + j
            inst = Instance(f"inst-{rank}", is_root=False)
            inst.topology = hostcpu.HostTopologyManager().query_topology()
            if not inst.topology.satisfies(template):
                with self._lock:
                    self._size -= count - j
                raise HiCRError("local topology cannot satisfy instance template")
            self.instances.append(inst)
            self.fabric.attach_rank(rank)
            t = threading.Thread(
                target=self._run_rank, args=(self.entry_fn, rank), daemon=True, name=f"inst-{rank}"
            )
            self._threads.append(t)
            t.start()
            created.append(inst)
        return tuple(created)

    def wait_instance(self, rank: int, timeout: float = 30.0) -> bool:
        """Join `rank`'s thread: True once the instance's entry function has
        actually returned/raised. A router uses this after observing a
        terminate/failure so requeue decisions never race the dying
        instance's final channel pushes (deterministic handoff, no sleeps)."""
        for t in self._threads:
            if t.name == f"inst-{rank}":
                t.join(timeout=timeout)
                return not t.is_alive()
        return True  # never started: nothing left to race against

    def join_elastic(self, timeout: float = 120.0, *, raise_on_error: bool = True):
        for t in self._threads:
            t.join(timeout=timeout)
        if self._errors and raise_on_error:
            rank, err = sorted(self._errors.items())[0]
            raise InstanceFailedError(f"instance {rank} failed: {err!r}") from err
        return dict(self._results)

    def instance_errors(self) -> Dict[int, BaseException]:
        """Per-rank entry-function errors (e.g. workers that died mid-serve
        and were handled by requeueing rather than re-raising)."""
        return dict(self._errors)

    def shutdown(self):
        for i in range(self.size()):
            self.fabric.detach_rank(i)
