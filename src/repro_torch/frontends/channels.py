"""Channels frontend (paper §4.3): frequent, persistent transfer of small
messages across instances with low-latency QoS.

Operates by exchanging pre-allocated circular buffers between sender and
receiver: the producer knows where to push the next message as long as the
buffer is not full; the consumer notifies consumption by advancing its head
counter. Transfer and synchronization messages are thereby decoupled —
minimal per-message handshaking.

Supported paradigms, as in the paper:
* **SPSC** — single producer, single consumer.
* **MPSC locking** — a shared channel guarded by collective exclusive access
  (a global lock), at the price of lock traffic.
* **MPSC non-locking** — dedicated per-producer buffers; no lock, more
  memory.

Built exclusively on the HiCR core API: slot allocation (MemoryManager),
collective slot exchange + one-sided memcpy + fence (CommunicationManager).
Counter updates are single-writer by construction: the producer owns the
tail counter, the consumer owns the head counter.

Two construction paths:
* **collective** (the default constructors) — both ends join the tag's
  collective slot exchange, as in the paper;
* **direct** (`connect_direct`) — the consumer registers its ring slots
  directly (the DataObject publish path) and the producer resolves them by
  (tag, key) with a bounded rendezvous retry. No collective means a channel
  can be wired to an instance created *at runtime* (paper §3.1.1 elastic
  instances — the serving fleet's router/worker links), and a dead end never
  strands the other participants in a barrier.
"""
from __future__ import annotations

import struct
import time
from collections import deque
from typing import Optional, Sequence

from repro_torch.core.definitions import FutureTimeoutError, HiCRError
from repro_torch.core.events import Event, Future
from repro_torch.core.managers import CommunicationManager, MemoryManager


def _push_event(channel, queue: "deque", data: bytes) -> Event:
    """Completion object for an asynchronous push: one eager nonblocking
    attempt now, then each poll retries until ring space frees up.

    FIFO is preserved regardless of poll order: pending pushes of one
    producer live in `queue` (submission order) and every event's poll
    drains *earlier* entries before its own, so a later push can never
    jump a still-pending earlier one into the ring."""
    ev = Event(name="channel-push")
    entry = (data, ev)
    queue.append(entry)

    def poll() -> bool:
        while queue[0] is not entry:
            head_data, head_ev = queue[0]
            if not channel.try_push(head_data):
                return False
            queue.popleft()
            head_ev.set()
        if channel.try_push(data):
            queue.popleft()
            return True
        return False

    ev.set_poll(poll)
    ev.done()  # eager attempt: an uncontended push completes here
    return ev


def pop_future(channel) -> Future:
    """Completion object for an asynchronous pop: polls the ring and resolves
    with the popped message bytes."""
    fut = Future(name="channel-pop")

    def poll() -> bool:
        data = channel.try_pop()
        if data is None:
            return False
        fut.set_result(data)
        return True

    fut.set_poll(poll)
    return fut


class ChannelMessageTooLargeError(HiCRError):
    """A message exceeds the channel's fixed msg_size. Rings carry
    fixed-size messages; an oversized payload cannot be shrunk by padding
    (`bytes.ljust` never truncates) and would corrupt neighbouring slots."""


# key layout within a channel's exchange tag
KEY_PAYLOAD = 0
KEY_TAIL = 1  # producer-written
KEY_HEAD = 2  # consumer-written
_CTR = struct.Struct("<q")
_PER_PRODUCER_STRIDE = 16


def _read_counter(comm: CommunicationManager, mem: MemoryManager, gslot, scratch) -> int:
    comm.memcpy(scratch, 0, gslot, 0, _CTR.size)
    comm.fence(gslot.tag)
    return _CTR.unpack(bytes(scratch.handle[: _CTR.size]))[0]


def _write_counter(comm: CommunicationManager, scratch, gslot, value: int) -> None:
    scratch.handle[: _CTR.size] = bytearray(_CTR.pack(value))
    comm.memcpy(gslot, 0, scratch, 0, _CTR.size)
    comm.fence(gslot.tag)


class _EndBase:
    def __init__(self, comm, mem, tag: int, capacity: int, msg_size: int):
        self.comm = comm
        self.mem = mem
        self.tag = tag
        self.capacity = capacity
        self.msg_size = msg_size
        space = mem.memory_spaces()[0]
        self._scratch = mem.allocate_local_memory_slot(space, max(msg_size, _CTR.size))
        self._space = space


def _poll_direct_handles(comm, tag: int, keys: Sequence[int], timeout: float):
    """Rendezvous with a directly-registered channel end: retry the handle
    lookup until the owning end has registered all `keys` under `tag`.
    Registration order on the owner side is irrelevant — the connect only
    proceeds once every key resolves."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return {k: comm.get_global_slot_handle(tag, k) for k in keys}
        except HiCRError:
            if time.monotonic() >= deadline:
                raise FutureTimeoutError(
                    f"channel tag {tag}: peer did not register keys {tuple(keys)} "
                    f"within {timeout}s"
                )
            time.sleep(0.0005)


class SPSCProducer(_EndBase):
    """Producer end. Construction participates in the collective exchange."""

    def __init__(self, comm, mem, tag: int, capacity: int, msg_size: int, *, key_offset: int = 0):
        super().__init__(comm, mem, tag, capacity, msg_size)
        gslots = comm.exchange_global_memory_slots(tag, {})
        self._payload = gslots[KEY_PAYLOAD + key_offset]
        self._tail_slot = gslots[KEY_TAIL + key_offset]
        self._head_slot = gslots[KEY_HEAD + key_offset]
        self._tail = 0
        self._cached_head = 0
        #: submission-ordered pending async pushes (see _push_event)
        self._push_queue: deque = deque()

    @classmethod
    def connect_direct(
        cls, comm, mem, tag: int, capacity: int, msg_size: int,
        *, key_offset: int = 0, timeout: float = 30.0,
    ) -> "SPSCProducer":
        """Non-collective construction: resolve the consumer's directly
        registered ring slots by (tag, key) instead of joining a collective
        exchange. This is how an *elastically created* instance (paper
        §3.1.1) attaches to a channel — a runtime-spawned worker cannot
        retroactively join the collectives the launch-time world already
        ran. Blocks (bounded by `timeout`) until the consumer end exists."""
        self = object.__new__(cls)
        _EndBase.__init__(self, comm, mem, tag, capacity, msg_size)
        handles = _poll_direct_handles(
            comm, tag,
            (KEY_PAYLOAD + key_offset, KEY_TAIL + key_offset, KEY_HEAD + key_offset),
            timeout,
        )
        self._payload = handles[KEY_PAYLOAD + key_offset]
        self._tail_slot = handles[KEY_TAIL + key_offset]
        self._head_slot = handles[KEY_HEAD + key_offset]
        self._tail = 0
        self._cached_head = 0
        self._push_queue = deque()
        return self

    def _full(self) -> bool:
        if self._tail - self._cached_head < self.capacity:
            return False
        self._cached_head = _read_counter(self.comm, self.mem, self._head_slot, self._scratch)
        return self._tail - self._cached_head >= self.capacity

    def _check_size(self, data: bytes) -> None:
        if len(data) > self.msg_size:
            raise ChannelMessageTooLargeError(
                f"message of {len(data)} bytes exceeds channel msg_size "
                f"{self.msg_size}"
            )

    def depth(self) -> int:
        """In-flight messages as seen from the producer (refreshes the
        consumer's head counter — one remote read)."""
        self._cached_head = _read_counter(self.comm, self.mem, self._head_slot, self._scratch)
        return self._tail - self._cached_head

    def try_push(self, data: bytes) -> bool:
        self._check_size(data)
        if self._full():
            return False
        slot_idx = self._tail % self.capacity
        self._scratch.handle[: len(data)] = bytearray(data)
        self.comm.memcpy(self._payload, slot_idx * self.msg_size, self._scratch, 0, self.msg_size)
        self.comm.fence(self.tag)
        self._tail += 1
        _write_counter(self.comm, self._scratch, self._tail_slot, self._tail)
        return True

    def push_async(self, data: bytes) -> Event:
        """Nonblocking push returning its completion Event (completes once
        ring space frees up and the message lands). Outstanding pushes of
        one producer land in submission order."""
        self._check_size(data)
        return _push_event(self, self._push_queue, data)

    def push(self, data: bytes, *, timeout: float = 30.0) -> None:
        """Blocking shim over `push_async`."""
        if not self.push_async(data).wait(timeout):
            raise TimeoutError("channel full")


class SPSCConsumer(_EndBase):
    """Consumer end: owns the buffers, volunteers them in the exchange."""

    def __init__(self, comm, mem, tag: int, capacity: int, msg_size: int, *, key_offset: int = 0):
        super().__init__(comm, mem, tag, capacity, msg_size)
        self._payload_local = mem.allocate_local_memory_slot(self._space, capacity * msg_size)
        self._tail_local = mem.allocate_local_memory_slot(self._space, _CTR.size)
        self._head_local = mem.allocate_local_memory_slot(self._space, _CTR.size)
        gslots = comm.exchange_global_memory_slots(
            tag,
            {
                KEY_PAYLOAD + key_offset: self._payload_local,
                KEY_TAIL + key_offset: self._tail_local,
                KEY_HEAD + key_offset: self._head_local,
            },
        )
        self._head_slot = gslots[KEY_HEAD + key_offset]
        self._tail_slot = gslots[KEY_TAIL + key_offset]
        self._head = 0

    @classmethod
    def connect_direct(
        cls, comm, mem, tag: int, capacity: int, msg_size: int, *, key_offset: int = 0,
    ) -> "SPSCConsumer":
        """Non-collective construction: allocate the ring buffers and make
        them remotely reachable via direct registration (the DataObject
        publish path) rather than a collective exchange — so a channel end
        can come up at any time, including on an elastically created
        instance. The producer attaches with `SPSCProducer.connect_direct`."""
        self = object.__new__(cls)
        _EndBase.__init__(self, comm, mem, tag, capacity, msg_size)
        self._payload_local = mem.allocate_local_memory_slot(self._space, capacity * msg_size)
        self._tail_local = mem.allocate_local_memory_slot(self._space, _CTR.size)
        self._head_local = mem.allocate_local_memory_slot(self._space, _CTR.size)
        comm.register_global_slot(tag, KEY_PAYLOAD + key_offset, self._payload_local)
        self._tail_slot = comm.register_global_slot(tag, KEY_TAIL + key_offset, self._tail_local)
        self._head_slot = comm.register_global_slot(tag, KEY_HEAD + key_offset, self._head_local)
        self._head = 0
        return self

    def depth(self) -> int:
        tail = _CTR.unpack(bytes(self._tail_local.handle[: _CTR.size]))[0]
        return tail - self._head

    def try_pop(self) -> Optional[bytes]:
        if self.depth() <= 0:
            return None
        slot_idx = self._head % self.capacity
        off = slot_idx * self.msg_size
        data = bytes(self._payload_local.handle[off : off + self.msg_size])
        self._head += 1
        _write_counter(self.comm, self._scratch, self._head_slot, self._head)
        return data

    def pop_async(self) -> Future:
        """Nonblocking pop returning a Future resolving to message bytes."""
        return pop_future(self)

    def pop(self, *, timeout: float = 30.0) -> bytes:
        """Blocking shim over `pop_async`."""
        fut = self.pop_async()
        if not fut.wait(timeout):
            raise TimeoutError("channel empty")
        return fut.result()


# ---------------------------------------------------------------------------
# MPSC
# ---------------------------------------------------------------------------


class MPSCLockingProducer(SPSCProducer):
    """Shared channel; collective exclusive access prevents overflow races.

    The global lock also protects the (read-tail, write-payload, bump-tail)
    critical section because multiple producers share one tail counter."""

    def depth(self) -> int:
        """The tail counter is shared between producers, so the locally
        cached copy may be stale: refresh both counters (head first, so a
        concurrent consumer cannot make the difference negative)."""
        self._cached_head = _read_counter(self.comm, self.mem, self._head_slot, self._scratch)
        self._tail = _read_counter(self.comm, self.mem, self._tail_slot, self._scratch)
        return self._tail - self._cached_head

    def try_push(self, data: bytes) -> bool:
        self._check_size(data)
        self.comm.acquire_global_lock(self.tag)
        try:
            # tail is shared between producers: re-read under the lock
            self._tail = _read_counter(self.comm, self.mem, self._tail_slot, self._scratch)
            if self._full():
                return False
            slot_idx = self._tail % self.capacity
            self._scratch.handle[: len(data)] = bytearray(data)
            self.comm.memcpy(self._payload, slot_idx * self.msg_size, self._scratch, 0, self.msg_size)
            self.comm.fence(self.tag)
            self._tail += 1
            _write_counter(self.comm, self._scratch, self._tail_slot, self._tail)
            return True
        finally:
            self.comm.release_global_lock(self.tag)


MPSCLockingConsumer = SPSCConsumer


class MPSCNonLockingProducer(SPSCProducer):
    """Dedicated buffer per producer: no lock, higher memory footprint. Each
    producer gets its own key range within the shared tag."""

    def __init__(self, comm, mem, tag: int, capacity: int, msg_size: int, *, producer_index: int):
        super().__init__(
            comm, mem, tag, capacity, msg_size,
            key_offset=producer_index * _PER_PRODUCER_STRIDE,
        )


class MPSCNonLockingConsumer:
    """Consumer owning one SPSC ring per producer; pops round-robin."""

    def __init__(self, comm, mem, tag: int, capacity: int, msg_size: int, *, n_producers: int):
        # one collective exchange covering all producer rings
        self.rings: list[SPSCConsumer] = []
        space = mem.memory_spaces()[0]
        contributions = {}
        locals_per_ring = []
        for p in range(n_producers):
            off = p * _PER_PRODUCER_STRIDE
            payload = mem.allocate_local_memory_slot(space, capacity * msg_size)
            tail = mem.allocate_local_memory_slot(space, _CTR.size)
            head = mem.allocate_local_memory_slot(space, _CTR.size)
            contributions[KEY_PAYLOAD + off] = payload
            contributions[KEY_TAIL + off] = tail
            contributions[KEY_HEAD + off] = head
            locals_per_ring.append((payload, tail, head))
        gslots = comm.exchange_global_memory_slots(tag, contributions)
        for p, (payload, tail, head) in enumerate(locals_per_ring):
            ring = object.__new__(SPSCConsumer)
            _EndBase.__init__(ring, comm, mem, tag, capacity, msg_size)
            off = p * _PER_PRODUCER_STRIDE
            ring._payload_local, ring._tail_local, ring._head_local = payload, tail, head
            ring._head_slot = gslots[KEY_HEAD + off]
            ring._tail_slot = gslots[KEY_TAIL + off]
            ring._head = 0
            self.rings.append(ring)
        self._rr = 0

    def depth(self) -> int:
        """Total messages pending across all producer rings."""
        return sum(ring.depth() for ring in self.rings)

    def try_pop(self) -> Optional[bytes]:
        for _ in range(len(self.rings)):
            ring = self.rings[self._rr]
            self._rr = (self._rr + 1) % len(self.rings)
            data = ring.try_pop()
            if data is not None:
                return data
        return None

    def pop_async(self) -> Future:
        """Nonblocking pop returning a Future resolving to message bytes."""
        return pop_future(self)

    def pop(self, *, timeout: float = 30.0) -> bytes:
        """Blocking shim over `pop_async`."""
        fut = self.pop_async()
        if not fut.wait(timeout):
            raise TimeoutError("channel empty")
        return fut.result()
