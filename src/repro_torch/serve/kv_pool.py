"""Paged KV-cache pool: HiCR-registered block-pool tensors + page accounting.
Port of `repro/serve/kv_pool.py`.

The per-layer block-pool tensors are allocated ONCE at construction and
registered with the runtime's `MemoryManager` as local memory slots; every
cache operation in the hot path then moves page *indices*, never pages —
admission reserves pages, decode growth draws them, eviction frees them,
all against a `MemorySlotPool` whose null page 0 is pinned so inactive
slots' masked writes can never land on live data. Unlike the reference's
immutable arrays, the tensors are updated in place by the commit and
decode execution units, so the registered slots alias the live cache.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.core.managers import MemorySlotPool


class PagedKVPool:
    """Block-pool KV cache for the paged serve path.

    Parameters
    ----------
    runtime:
        Runtime whose `MemoryManager` registers the pool tensors (a runtime
        without a memory role skips registration but keeps accounting).
    model:
        `ModelBundle` with `paged_ops`.
    layout:
        `PagedLayout` from `model.paged_ops.layout(...)`.
    device:
        Device the pools are allocated on.
    """

    def __init__(self, runtime, model, layout, *, device):
        if model.paged_ops is None:
            raise ValueError(
                f"model family {model.cfg.family!r} has no paged KV-cache path"
            )
        self.layout = layout
        #: Per-layer (k, v) block-pool tensors, updated in place.
        self.pools = model.paged_ops.init_pools(layout, device=device)

        leaves: List[torch.Tensor] = [t for kv in self.pools for t in kv]
        self.slots: List = []
        mm = getattr(runtime, "memory_manager", None)
        if mm is not None:
            space = mm.memory_spaces()[0]
            for leaf in leaves:
                self.slots.append(mm.register_tensor_slot(space, leaf))

        # one logical page spans every full-layer pool: aggregate their bytes
        full_bytes = sum(leaf.nbytes for leaf in leaves if leaf.shape[0] == layout.num_pages)
        self.accounting = MemorySlotPool(
            max(1, full_bytes // layout.num_pages),
            layout.num_pages,
            backing=tuple(self.slots),
            reserved_blocks=(0,),  # null page: padding + inactive-write sink
        )

    # -- page operations (hot path: indices only) ----------------------------
    def can_admit(self, n_pages: int) -> bool:
        return self.accounting.can_reserve(n_pages)

    def reserve(self, n_pages: int) -> bool:
        return self.accounting.reserve(n_pages)

    def draw(self, n_pages: int) -> List[int]:
        return self.accounting.draw(n_pages)

    def free(self, pages: Sequence[int], *, unreserve: int = 0) -> None:
        """Drop one holder per page (a finished slot returning its pages)
        and release whatever part of its reservation was never drawn."""
        self.accounting.free(pages)
        if unreserve:
            self.accounting.unreserve(unreserve)

    # -- shared pages (prefix cache: fork-by-reference) -----------------------
    def acquire(self, pages: Sequence[int]) -> None:
        """Add one holder to each page (share an existing allocation)."""
        self.accounting.acquire(pages)

    # paper-facing alias: fork a page table entry by reference
    share = acquire

    def release(self, pages: Sequence[int]) -> None:
        """Drop one holder per page; last holder frees the page."""
        self.accounting.release(pages)

    def refcount(self, page: int) -> int:
        return self.accounting.refcount(page)

    # -- introspection --------------------------------------------------------
    @property
    def pages_free(self) -> int:
        return self.accounting.blocks_free

    @property
    def pages_available(self) -> int:
        """Free pages not spoken for by an outstanding reservation."""
        return self.accounting.blocks_available

    @property
    def pages_used(self) -> int:
        return self.accounting.blocks_used

    @property
    def capacity(self) -> int:
        return self.accounting.capacity
