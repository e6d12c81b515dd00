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

With ``prefix_cache=True`` (paged mode only) admission first asks a
refcounted `RadixCache` (`serve/prefix_cache.py`) for the longest cached
prefix of the prompt: fully matched pages are forked by reference into the
slot's page table (the worst-case reservation shrinks by the shared pages),
a partially matched boundary page is copy-on-write forked through the tail
prefill's gather, and only the uncached tail runs through the model.
Completion returns pages to the cache instead of freeing them; page pressure
LRU-evicts pages only the cache holds before refusing admission.

Token semantics match the reference's scheduler exactly in every mode: the
first emitted token is the greedy pick from the prefill logits; each later
token comes from one decode step at the request's own position.

With tracing on (`core/tracing.py`) each admission is a ``sched.admit`` span
and each step a ``sched.step`` span (paged: ``sched.grow``, the decoder's
``decoder.interval`` and ``sched.harvest`` inside it), whose meta count the
tokens each slot had before the step and made in it.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core import tracing
from repro_torch.core.runtime import Runtime
from repro_torch.models.model_zoo import ModelBundle

from .batching import PagedSlotDecoder, SlotDecoder
from .prefix_cache import RadixCache


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
    (None/None in dense mode: there is no shared pool to meter), the
    admission headroom in free slots, and the radix cache's counters
    (`RadixCache.stats`) when the prefix cache is on, else None."""

    requests: Dict[str, List[int]]
    pages_free: Optional[int] = None
    pages_used: Optional[int] = None
    free_slots: int = 0
    prefix: Optional[dict] = None


@dataclasses.dataclass
class _Active:
    """Request-table row: one admitted request bound to a decoder slot."""

    request: Request
    slot: int
    emitted: List[int]
    pages: List[int] = dataclasses.field(default_factory=list)  # drawn pages
    reserved_left: int = 0  # reserved-but-undrawn pages
    #: prefix-cache pages forked by reference (head of the page-table row);
    #: the row holds one pool reference per shared page while active
    shared: List[int] = dataclasses.field(default_factory=list)


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
        self.kv_mode = kv_mode
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefix: Optional[RadixCache] = None
        if kv_mode == "dense":
            self.decoder = SlotDecoder(
                model, params, max_slots=max_batch, max_len=max_len, runtime=runtime
            )
        else:
            self.decoder = PagedSlotDecoder(
                model, params, max_slots=max_batch, max_len=max_len,
                page_size=page_size, pool_pages=pool_pages,
                sync_interval=sync_interval, runtime=runtime,
                shared_prefix=prefix_cache,
            )
            if prefix_cache:
                self.prefix = RadixCache(self.decoder.kv, self.decoder.layout.page_size)
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
                prefix=self.prefix.stats() if self.prefix is not None else None,
            )
        return SchedulerProgress(requests=requests, free_slots=self.free_slots)

    # -- admission (any time, including mid-decode) -------------------------
    def try_admit(self, request: Request) -> bool:
        """Prefill `request` and seat it in a free slot. Returns False when
        the table is full or, in paged mode, when the KV pool cannot reserve
        the request's worst-case pages (backpressure); a request needing
        more pages than the pool holds raises. Requests finishing at their
        first token are completed without consuming a slot."""
        with tracing.span("sched.admit", rid=request.rid, prompt=len(request.prompt)) as sp:
            admitted = self._admit(request, sp)
            sp.note(admitted=admitted)
            return admitted

    def _admit(self, request: Request, sp) -> bool:
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

        pages_total = new_pages = 0
        m = None  # prefix-cache match (None when the cache is off)
        if self.kv_mode == "paged":
            layout = self.decoder.layout
            kv = self.decoder.kv
            pages_total = layout.pages_for(total_positions)
            n_shared = 0
            if self.prefix is not None:
                m = self.prefix.match(request.prompt)
                n_shared = len(m.nodes)
            # shared pages are already resident: only the new ones need
            # reserving (the worst case shrinks with the matched prefix)
            new_pages = pages_total - n_shared
            if new_pages > kv.capacity:
                raise ValueError(
                    f"request {request.rid!r} needs {new_pages} KV pages, "
                    f"pool capacity is {kv.capacity}"
                )
            if m is not None:
                self.prefix.lock(m)
            if not kv.reserve(new_pages):
                # page pressure: LRU-evict cache-only pages before refusing
                if self.prefix is not None:
                    self.prefix.evict(new_pages - kv.pages_available)
                if not kv.reserve(new_pages):
                    if m is not None and self.active_count == 0:
                        # nothing in flight will ever free pages, and our own
                        # lock may pin every evictable page: demote the match
                        # to a miss so eviction can reclaim them (returning
                        # False here would livelock serve())
                        self.prefix.unlock(m)
                        m = None
                        new_pages = pages_total
                        if new_pages > kv.capacity:
                            raise ValueError(
                                f"request {request.rid!r} needs {new_pages} KV "
                                f"pages uncached, pool capacity is {kv.capacity}"
                            )
                        self.prefix.evict(new_pages - kv.pages_available)
                    if not kv.reserve(new_pages):
                        if m is not None:
                            self.prefix.unlock(m)
                        return False  # retry once pages free up

        sp.note(shared_pages=len(m.nodes) if m is not None else 0, new_pages=new_pages)
        try:
            if self.prefix is not None:
                # shared-prefix decoders always admit through the gather
                # unit (a miss, matched or demoted, gathers null pages)
                off = m.matched_len if m is not None else 0
                row = (self._gather_row(m) if m is not None
                       else np.zeros((self.decoder.layout.n_pages_seq,), np.int32))
                first, state = self.decoder.prefill_prefix(request.prompt[off:], row, off)
            else:
                first, state = self.decoder.prefill(request.prompt)
        except BaseException:
            if new_pages:  # a failed prefill must not strand the reservation
                self.decoder.kv.free((), unreserve=new_pages)
            if m is not None:
                self.prefix.unlock(m)
            raise
        emitted = [first]
        if request.max_new_tokens == 1 or first == request.eos_id:
            if new_pages:
                self.decoder.kv.free((), unreserve=new_pages)
            if self.prefix is not None:
                if m is not None:
                    self.prefix.unlock(m)  # nothing committed: no donation
                self.prefix.note(m, prompt_len)
            self._finished.append(self._finish(request, emitted))
            return True
        slot = self._free.popleft()
        if self.kv_mode == "dense":
            self.decoder.load(slot, state, first, prompt_len)
            self._table[slot] = _Active(request=request, slot=slot, emitted=emitted)
            return True
        layout = self.decoder.layout
        shared = m.shared_pages if m is not None else []
        n_shared = len(shared)
        # draw pages for everything prefill wrote + the first decode write;
        # the rest of the reservation is drawn as the slot grows
        pages_now = layout.pages_for(prompt_len + 1)
        drawn = self.decoder.kv.draw(pages_now - n_shared)
        self._page_table[slot, :] = 0
        self._page_table[slot, :n_shared] = shared
        self._page_table[slot, n_shared : n_shared + len(drawn)] = drawn
        # shared pages are read-only: the commit scatters the dense state's
        # prefix region into the null page instead
        commit_row = self._page_table[slot].copy()
        commit_row[:n_shared] = 0
        self.decoder.load(
            slot, state, first, prompt_len,
            steps_left=request.max_new_tokens - 1,
            eos_id=request.eos_id,
            capacity=pages_total * layout.page_size,
            full_row=commit_row,
        )
        if self.prefix is not None:
            if m is not None:
                self.prefix.unlock_boundary(m)  # its content is copied now
            self.prefix.note(m, prompt_len)
        self._pos_host[slot] = prompt_len
        self._table[slot] = _Active(
            request=request, slot=slot, emitted=emitted,
            pages=drawn, reserved_left=pages_total - pages_now, shared=shared,
        )
        return True

    def _gather_row(self, m) -> np.ndarray:
        """Page-table row for the tail prefill's prefix gather: the matched
        pages (by reference) plus the copy-on-write boundary source,
        null-padded (padded gathers read the null page and sit past every
        position the tail can attend)."""
        row = np.zeros((self.decoder.layout.n_pages_seq,), dtype=np.int32)
        shared = m.shared_pages
        row[: len(shared)] = shared
        if m.boundary is not None:
            row[len(shared)] = m.boundary.page
        return row

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
        with tracing.span("sched.step") as sp:
            if sp:
                rows = [(row, len(row.emitted)) for row in self._table if row is not None]
                ticks = self.ticks
            done, self._finished = self._finished, []
            if self.active_count:  # nothing to decode: skip the tick
                done += self._step_dense() if self.kv_mode == "dense" else self._step_paged()
            if sp:
                sp.note(ticks=self.ticks - ticks, finished=[f.rid for f in done],
                        slots=[(row.request.rid, n0, len(row.emitted) - n0) for row, n0 in rows])
        return done

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
            filled = len(row.shared) + len(row.pages)
            delta = min(target - filled, row.reserved_left)
            if delta > 0:
                drawn = self.decoder.kv.draw(delta)
                self._page_table[slot, filled : filled + delta] = drawn
                row.pages.extend(drawn)
                row.reserved_left -= delta

    def _step_paged(self) -> List[FinishedRequest]:
        done: List[FinishedRequest] = []
        with tracing.span("sched.grow"):
            self._grow_pages()
        out_buf, done_mask, pos = self.decoder.run_interval(self._page_table)
        self._pos_host[:] = pos
        self.ticks += self.decoder.sync_interval
        with tracing.span("sched.harvest"):
            self._harvest(out_buf, done_mask, done)
        return done

    def _harvest(self, out_buf, done_mask, done: List[FinishedRequest]) -> None:
        """At a sync point: append each slot's new tokens and evict the
        slots that finished, into `done`."""
        for slot, row in enumerate(self._table):
            if row is None:
                continue
            ticks = out_buf[slot]
            row.emitted.extend(int(t) for t in ticks[ticks >= 0])
            if done_mask[slot]:
                done.append(self._finish(row.request, row.emitted))
                if self.prefix is not None:
                    # return pages through the radix cache: full pages of the
                    # written sequence are donated or shared, the rest freed.
                    # Positions written: the prompt plus every emitted token
                    # that was fed back (the last one never was)
                    seq = list(row.request.prompt) + row.emitted[:-1]
                    self.prefix.commit(seq, row.shared + row.pages)
                    self.decoder.kv.free((), unreserve=row.reserved_left)
                else:
                    self.decoder.kv.free(row.pages, unreserve=row.reserved_left)
                self._page_table[slot, :] = 0
                self._table[slot] = None
                self._free.append(slot)

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
