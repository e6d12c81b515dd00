"""Continuous-batching scheduler: slot-based request table over the dense
`SlotDecoder` or the paged `PagedSlotDecoder`. Port of
`repro/serve/scheduler.py`.

Requests are admitted whenever a slot is free — including mid-decode of
other requests — and slots are evicted the moment a request hits its eos
token, its token budget or the cache ceiling; freed slots are reused by the
next admission. Two KV-cache modes:

* ``kv_mode="dense"`` (the default, as in the reference) — every slot owns
  a `max_len`-deep cache (`SlotDecoder`); one batched decode step per
  scheduler tick, tokens synced to the host every tick.
* ``kv_mode="paged"`` — slots share a block-pool cache addressed through a
  scheduler-owned page table (`PagedSlotDecoder`): pages are reserved at
  admission (admission control is page availability, not a slot count),
  drawn as a request grows, and freed at eviction. Each scheduler tick runs
  `sync_interval` fused decode+sample ticks on the device, so tokens,
  positions and done flags cross to the host only at sync points.

Token semantics match the reference's scheduler exactly in both modes: the
first emitted token is the greedy pick from the prefill logits; each later
token comes from one decode step at the request's own position. The prefix
cache (``prefix_cache=True``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core.runtime import Runtime
from repro_torch.models.model_zoo import ModelBundle

from .batching import PagedSlotDecoder, SlotDecoder


@dataclasses.dataclass
class Request:
    """One generation request. `max_new_tokens` bounds the decode length;
    `eos_id` (optional) triggers early eviction."""

    rid: str
    prompt: Sequence[int]
    max_new_tokens: int
    eos_id: Optional[int] = None


@dataclasses.dataclass
class FinishedRequest:
    rid: str
    prompt: List[int]
    tokens: List[int]
    finish_reason: str  # "length" | "eos" | "max_len"


@dataclasses.dataclass
class SchedulerProgress:
    """Snapshot for a streaming front door: tokens emitted so far per
    *active* request (copies), the KV-pool occupancy in paged mode
    (None/None in dense mode: there is no shared pool to meter), and the
    admission headroom in free slots."""

    requests: Dict[str, List[int]]
    pages_free: Optional[int] = None
    pages_used: Optional[int] = None
    free_slots: int = 0


@dataclasses.dataclass
class _Active:
    """Request-table row: one admitted request bound to a decoder slot."""

    request: Request
    slot: int
    emitted: List[int]
    pages: List[int] = dataclasses.field(default_factory=list)  # drawn pages
    reserved_left: int = 0  # reserved-but-undrawn pages


class ContinuousBatchingScheduler:
    def __init__(
        self,
        model: ModelBundle,
        params,
        *,
        max_batch: int = 8,
        max_len: int = 256,
        runtime: Optional[Runtime] = None,
        kv_mode: str = "dense",
        page_size: int = 16,
        pool_pages: Optional[int] = None,
        sync_interval: int = 8,
        prefix_cache: bool = False,
    ):
        if kv_mode not in ("dense", "paged"):
            raise ValueError(f"kv_mode must be 'dense' or 'paged', got {kv_mode!r}")
        if prefix_cache and kv_mode != "paged":
            raise ValueError(
                "prefix_cache requires kv_mode='paged' (prefixes are shared "
                "as pool pages; dense slots own private caches)"
            )
        if prefix_cache:
            raise NotImplementedError("prefix_cache=True is not ported yet")
        self.kv_mode = kv_mode
        self.max_batch = max_batch
        self.max_len = max_len
        if kv_mode == "dense":
            self.decoder = SlotDecoder(
                model, params, max_slots=max_batch, max_len=max_len, runtime=runtime
            )
        else:
            self.decoder = PagedSlotDecoder(
                model, params, max_slots=max_batch, max_len=max_len,
                page_size=page_size, pool_pages=pool_pages,
                sync_interval=sync_interval, runtime=runtime,
            )
            #: scheduler-owned page table: logical page j of slot s ->
            #: physical pool page (0 = null/unallocated)
            self._page_table = np.zeros(
                (max_batch, self.decoder.layout.n_pages_seq), dtype=np.int32
            )
            #: host mirror of per-slot positions (set at admission, refreshed
            #: at every sync point) — growth never reads back from the device
            self._pos_host = np.zeros((max_batch,), dtype=np.int32)
        self._table: List[Optional[_Active]] = [None] * max_batch
        self._free: deque[int] = deque(range(max_batch))
        self._finished: List[FinishedRequest] = []
        self.ticks = 0

    # -- introspection ------------------------------------------------------
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.max_batch - len(self._free)

    def active_progress(self) -> SchedulerProgress:
        requests = {
            row.request.rid: list(row.emitted) for row in self._table if row is not None
        }
        if self.kv_mode == "paged":
            kv = self.decoder.kv
            return SchedulerProgress(
                requests=requests, pages_free=kv.pages_free, pages_used=kv.pages_used,
                free_slots=self.free_slots,
            )
        return SchedulerProgress(requests=requests, free_slots=self.free_slots)

    # -- admission (any time, including mid-decode) -------------------------
    def try_admit(self, request: Request) -> bool:
        """Prefill `request` and seat it in a free slot. Returns False when
        the table is full or, in paged mode, when the KV pool cannot reserve
        the request's worst-case pages (backpressure); a request needing
        more pages than the pool holds raises. Requests finishing at their
        first token are completed without consuming a slot."""
        if request.max_new_tokens < 1:
            raise ValueError(f"request {request.rid!r}: max_new_tokens must be >= 1")
        prompt_len = len(request.prompt)
        total_positions = prompt_len + request.max_new_tokens
        if total_positions > self.max_len:
            raise ValueError(
                f"request {request.rid!r} needs {total_positions} cache positions, "
                f"scheduler max_len is {self.max_len}"
            )
        if any(row is not None and row.request.rid == request.rid for row in self._table):
            raise ValueError(f"request id {request.rid!r} is already active")
        if not self._free:
            return False

        pages_total = 0
        if self.kv_mode == "paged":
            kv = self.decoder.kv
            pages_total = self.decoder.layout.pages_for(total_positions)
            if pages_total > kv.capacity:
                raise ValueError(
                    f"request {request.rid!r} needs {pages_total} KV pages, "
                    f"pool capacity is {kv.capacity}"
                )
            if not kv.reserve(pages_total):
                return False  # retry once pages free up

        try:
            first, state = self.decoder.prefill(request.prompt)
        except BaseException:
            if pages_total:  # a failed prefill must not strand the reservation
                self.decoder.kv.free((), unreserve=pages_total)
            raise
        emitted = [first]
        if request.max_new_tokens == 1 or first == request.eos_id:
            if pages_total:
                self.decoder.kv.free((), unreserve=pages_total)
            self._finished.append(self._finish(request, emitted))
            return True
        slot = self._free.popleft()
        if self.kv_mode == "dense":
            self.decoder.load(slot, state, first, prompt_len)
            self._table[slot] = _Active(request=request, slot=slot, emitted=emitted)
            return True
        layout = self.decoder.layout
        # draw pages for everything prefill wrote + the first decode write;
        # the rest of the reservation is drawn as the slot grows
        pages_now = layout.pages_for(prompt_len + 1)
        drawn = self.decoder.kv.draw(pages_now)
        self._page_table[slot, :] = 0
        self._page_table[slot, : len(drawn)] = drawn
        self.decoder.load(
            slot, state, first, prompt_len,
            steps_left=request.max_new_tokens - 1,
            eos_id=request.eos_id,
            capacity=pages_total * layout.page_size,
            full_row=self._page_table[slot].copy(),
        )
        self._pos_host[slot] = prompt_len
        self._table[slot] = _Active(
            request=request, slot=slot, emitted=emitted,
            pages=drawn, reserved_left=pages_total - pages_now,
        )
        return True

    def _finish(self, request: Request, emitted: List[int]) -> FinishedRequest:
        if emitted and emitted[-1] == request.eos_id:
            reason = "eos"
        elif len(emitted) >= request.max_new_tokens:
            reason = "length"
        else:
            reason = "max_len"
        return FinishedRequest(
            rid=request.rid, prompt=list(request.prompt), tokens=emitted, finish_reason=reason,
        )

    # -- one scheduler tick --------------------------------------------------
    def step(self) -> List[FinishedRequest]:
        """Advance decoding and evict every request that completed; also
        drains requests that finished at admission. Dense mode runs one
        batched decode tick; paged mode runs one fused `sync_interval`-tick
        interval on the device and harvests at the sync point. Returns the
        newly finished requests."""
        done, self._finished = self._finished, []
        if self.active_count == 0:  # nothing to decode: skip the tick
            return done
        if self.kv_mode == "dense":
            return done + self._step_dense()
        return done + self._step_paged()

    def _step_dense(self) -> List[FinishedRequest]:
        done: List[FinishedRequest] = []
        new_tokens = self.decoder.step()
        self.ticks += 1
        # the eviction ceiling comes from the decoder's allocated cache
        # depth, not a separately tracked token budget
        capacity = self.decoder.cache_capacity
        for slot, row in enumerate(self._table):
            if row is None:
                continue
            tok = int(new_tokens[slot])
            row.emitted.append(tok)
            req = row.request
            hit_eos = tok == req.eos_id
            out_of_budget = len(row.emitted) >= req.max_new_tokens
            out_of_cache = int(self.decoder.pos[slot]) >= capacity
            if hit_eos or out_of_budget or out_of_cache:
                done.append(self._finish(req, row.emitted))
                self._table[slot] = None
                self._free.append(slot)
        return done

    def _grow_pages(self) -> None:
        """Before an interval: draw enough reserved pages for every active
        slot to cover `sync_interval` more positions. Reservations were made
        at admission, so a draw can never fail mid-flight."""
        layout = self.decoder.layout
        for slot, row in enumerate(self._table):
            if row is None or not row.reserved_left:
                continue
            target = layout.pages_for(int(self._pos_host[slot]) + self.decoder.sync_interval)
            filled = len(row.pages)
            delta = min(target - filled, row.reserved_left)
            if delta > 0:
                drawn = self.decoder.kv.draw(delta)
                self._page_table[slot, filled : filled + delta] = drawn
                row.pages.extend(drawn)
                row.reserved_left -= delta

    def _step_paged(self) -> List[FinishedRequest]:
        done: List[FinishedRequest] = []
        self._grow_pages()
        out_buf, done_mask, pos = self.decoder.run_interval(self._page_table)
        self._pos_host[:] = pos
        self.ticks += self.decoder.sync_interval
        for slot, row in enumerate(self._table):
            if row is None:
                continue
            ticks = out_buf[slot]
            row.emitted.extend(int(t) for t in ticks[ticks >= 0])
            if done_mask[slot]:
                done.append(self._finish(row.request, row.emitted))
                self.decoder.kv.free(row.pages, unreserve=row.reserved_left)
                self._page_table[slot, :] = 0
                self._table[slot] = None
                self._free.append(slot)
        return done

    # -- batch loop ----------------------------------------------------------
    def serve(self, requests: Iterable[Request]) -> Dict[str, FinishedRequest]:
        """Drive a full workload: admit whenever a slot frees up, tick until
        every request has completed. Returns results keyed by request id."""
        backlog = deque(requests)
        results: Dict[str, FinishedRequest] = {}
        expected = len(backlog)
        n_done = 0  # count finishes, not dict keys: duplicate rids must not hang
        while n_done < expected:
            while backlog and self.try_admit(backlog[0]):
                backlog.popleft()
            for fin in self.step():
                results[fin.rid] = fin
                n_done += 1
        return results
