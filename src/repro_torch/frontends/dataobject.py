"""DataObject frontend (paper §4.3): sporadic communication of large data
objects (e.g. multi-dimensional tensors) without pre-exchanged buffers.

* ``publish(slot)`` makes a block of data remotely accessible and returns a
  unique identifier (serializable; typically shipped over a Channel or RPC).
* ``get_handle(ident)`` resolves the identifier into a handle carrying only
  the metadata required to reach the remote object.
* ``get(handle, dst_slot)`` starts an asynchronous transfer of the data into
  a local slot; completion is fenced like any other HiCR transfer.

The reference's training framework publishes checkpoint shards this way
(`repro/train/checkpoint.py`); the port's checkpoint module is the reader
only, so here the frontend serves its tests and apps.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import threading

from repro_torch.core.stateful import GlobalMemorySlot, LocalMemorySlot

_TAG_BASE = 1 << 20  # tag namespace reserved for data objects
_counter = itertools.count(1)
_counter_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class DataObjectId:
    tag: int
    key: int
    size_bytes: int

    def serialize(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @staticmethod
    def deserialize(blob: bytes) -> "DataObjectId":
        return DataObjectId(**json.loads(blob.decode()))


class DataObjectEngine:
    def __init__(self, comm, mem, *, instance_rank: int = 0):
        self.comm = comm
        self.mem = mem
        self.rank = instance_rank
        self._published: dict[tuple[int, int], GlobalMemorySlot] = {}

    # -- producer side ---------------------------------------------------------
    def publish(self, slot: LocalMemorySlot) -> DataObjectId:
        with _counter_lock:
            key = next(_counter)
        tag = _TAG_BASE + self.rank
        gslot = self.comm.register_global_slot(tag, key, slot)
        self._published[(tag, key)] = gslot
        return DataObjectId(tag=tag, key=key, size_bytes=slot.size_bytes)

    def unpublish(self, ident: DataObjectId) -> None:
        gslot = self._published.pop((ident.tag, ident.key), None)
        if gslot is not None:
            self.comm.destroy_global_memory_slot(gslot)

    # -- consumer side -----------------------------------------------------------
    def get_handle(self, ident: DataObjectId) -> GlobalMemorySlot:
        return self.comm.get_global_slot_handle(ident.tag, ident.key)

    def get(self, handle: GlobalMemorySlot, dst: LocalMemorySlot, *, fence: bool = True) -> None:
        """Asynchronously fetch the published data into `dst`."""
        if dst.size_bytes < handle.size_bytes:
            raise ValueError("destination slot smaller than data object")
        self.comm.memcpy(dst, 0, handle, 0, handle.size_bytes)
        if fence:
            self.comm.fence(handle.tag)

    def fetch(self, ident: DataObjectId) -> LocalMemorySlot:
        """Convenience: resolve + allocate + get + fence."""
        handle = self.get_handle(ident)
        space = self.mem.memory_spaces()[0]
        dst = self.mem.allocate_local_memory_slot(space, handle.size_bytes)
        self.get(handle, dst)
        return dst
