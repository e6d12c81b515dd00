"""First-class completion objects for the HiCR model's asynchrony.

The paper declares both kernel execution and memcpy *asynchronous*
(§3.1.4-3.1.5: "completion is NOT guaranteed when the call returns"), and
prescribes blocking *and* non-blocking completion queries. This module turns
that contract into composable objects, the way task-based runtimes (Specx;
Thomadakis & Chrisochoides 2023) expose it:

* `Event`   — a one-shot completion signal: `done()`, `wait(timeout)`,
  `add_callback(fn)`.
* `Future`  — an Event carrying a result or exception: `result(timeout)`,
  `exception(timeout)`.
* `wait_all` / `wait_any` — combinators multiplexing heterogeneous
  completion sources (thread-backed, poll-backed, channel-backed) in one
  call, which is what lets a single loop overlap compute, transfers, and
  messaging.

Two completion styles are unified here because HiCR backends genuinely
differ in how completion is *discovered*:

* **signalled** — some other thread of control learns about completion and
  calls `set()` / `set_result()` (hostcpu worker threads, the localsim NIC
  threads).
* **polled** — completion must be asked for (XLA dispatch readiness, a
  channel's ring counters, an RPC reply queue). Such events are created
  with `set_poll(fn)`; every `done()`/`wait()` invokes the poll hook until
  it reports completion. A poll hook may resolve the event itself (e.g. by
  calling `set_result`); returning True alone marks the event done.

An optional `set_waiter(fn)` hook gives poll-backed events an efficient
untimed wait (e.g. `jax.block_until_ready`) instead of a poll loop.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, List, Optional, Sequence

from .definitions import FutureTimeoutError

__all__ = [
    "Event",
    "Future",
    "completed_event",
    "completed_future",
    "failed_future",
    "wait_all",
    "wait_any",
]

#: Sleep between completion polls. 0 yields the GIL without a timed sleep —
#: the same cadence the busy-wait loops this module replaces used.
_POLL_INTERVAL = 0.0


class Event:
    """One-shot completion signal (paper §3.1.4/§3.1.5 completion queries).

    Thread-safe. Callbacks added after completion fire immediately, on the
    caller's thread; callbacks added before completion fire on whichever
    thread observes or triggers completion. An Event never un-completes.
    """

    def __init__(self, *, name: str = "event"):
        self.name = name
        self._flag = threading.Event()
        # RLock: a poll hook (which runs under the lock) may resolve the
        # event itself via set()/set_result() — that re-entry must not
        # deadlock.
        self._lock = threading.RLock()
        self._callbacks: List[Callable[["Event"], None]] = []
        self._poll: Optional[Callable[[], bool]] = None
        self._waiter: Optional[Callable[[], None]] = None

    # -- completion sources ---------------------------------------------------
    def set(self) -> None:
        """Mark complete and fire pending callbacks. Idempotent."""
        with self._lock:
            if self._flag.is_set():
                return
            self._flag.set()
            callbacks, self._callbacks = self._callbacks, []
            self._poll = None
        for cb in callbacks:
            cb(self)

    def set_poll(self, poll: Callable[[], bool]) -> "Event":
        """Attach a poll hook discovering completion on demand. Returns self.

        The hook runs under the event's lock, so it is never invoked
        concurrently with itself and never again after completion — a hook
        with side effects (a channel push attempt, an RPC queue drain) runs
        its critical section exactly until it first succeeds.
        """
        self._poll = poll
        return self

    def set_waiter(self, waiter: Callable[[], None]) -> "Event":
        """Attach an efficient blocking wait for poll-backed events (called
        only by untimed `wait()`; must return once the work completed)."""
        self._waiter = waiter
        return self

    # -- completion queries ---------------------------------------------------
    def done(self) -> bool:
        """Non-blocking completion query (may invoke the poll hook)."""
        if self._flag.is_set():
            return True
        with self._lock:
            if self._flag.is_set():
                return True
            poll = self._poll
            if poll is None or not poll():
                return False
            # the hook may already have resolved us (set_result from inside)
            self._poll = None
        self.set()
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until complete. Returns False on timeout."""
        if self._flag.is_set():
            return True
        if self._poll is None:
            return self._flag.wait(timeout)
        if timeout is None and self._waiter is not None:
            self._waiter()
            if not self.done():  # waiter returned without resolving: poll once
                self.set()
            return True
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.done():
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(_POLL_INTERVAL)
        return True

    def add_callback(self, fn: Callable[["Event"], None]) -> None:
        """Run `fn(event)` on completion; immediately if already complete."""
        with self._lock:
            if not self._flag.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _remove_callback(self, fn: Callable[["Event"], None]) -> None:
        """Internal: detach a not-yet-fired callback (wait_any cleans up its
        wake-up hooks so retry loops don't accumulate them)."""
        with self._lock:
            try:
                self._callbacks.remove(fn)
            except ValueError:
                pass

    def __repr__(self):
        state = "done" if self._flag.is_set() else "pending"
        return f"{type(self).__name__}({self.name!r}, {state})"


class Future(Event):
    """An Event that additionally carries a result or an exception."""

    def __init__(self, *, name: str = "future"):
        super().__init__(name=name)
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def set_result(self, value: Any) -> None:
        self._result = value
        self.set()

    def set_exception(self, error: BaseException) -> None:
        self._error = error
        self.set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block for completion, then return the result or raise the carried
        exception. Raises `FutureTimeoutError` on timeout."""
        if not self.wait(timeout):
            raise FutureTimeoutError(
                f"{self.name}: no completion within {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._result

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        """Block for completion, then return the carried exception (or None)."""
        if not self.wait(timeout):
            raise FutureTimeoutError(
                f"{self.name}: no completion within {timeout}s"
            )
        return self._error


def completed_event(*, name: str = "completed") -> Event:
    """An Event born complete (synchronous backends' memcpy return value)."""
    ev = Event(name=name)
    ev.set()
    return ev


def completed_future(value: Any = None, *, name: str = "completed") -> Future:
    fut = Future(name=name)
    fut.set_result(value)
    return fut


def failed_future(error: BaseException, *, name: str = "failed") -> Future:
    fut = Future(name=name)
    fut.set_exception(error)
    return fut


def _as_tuple(events: Iterable[Event]) -> Sequence[Event]:
    out = tuple(events)
    for e in out:
        if not isinstance(e, Event):
            raise TypeError(f"wait_all/wait_any take Events, got {type(e).__name__}")
    return out


def wait_all(events: Iterable[Event], timeout: Optional[float] = None) -> bool:
    """Block until every event completed. Returns False on timeout.

    Mixed completion styles are fine: signalled events are awaited with
    their native blocking wait; poll-backed events are polled.
    """
    pending = list(_as_tuple(events))
    deadline = None if timeout is None else time.monotonic() + timeout
    # Drain in iteration order: poll-backed events with ordering side
    # effects (queued channel pushes) then complete in submission order.
    for event in pending:
        remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
        if not event.wait(remaining):
            return False
    return True


def wait_any(
    events: Iterable[Event], timeout: Optional[float] = None
) -> Optional[Event]:
    """Block until at least one event completed; return the first such event
    (or None on timeout). With several already-complete events, the earliest
    in iteration order wins — deterministic for testing."""
    evs = _as_tuple(events)
    if not evs:
        raise ValueError("wait_any of no events would never return")
    # Multiplex signalled events through one shared flag so we don't spin
    # when nothing is poll-backed. The hook is removed on exit — a caller
    # retrying wait_any in a loop must not accumulate callbacks on events
    # that stay pending across iterations.
    any_flag = threading.Event()
    wake = lambda _e: any_flag.set()  # noqa: E731 - needs identity for removal
    for e in evs:
        e.add_callback(wake)
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            for e in evs:
                if e.done():
                    return e
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return None
            # Poll-backed events only complete when asked: keep the wait
            # short enough to re-poll, but park on the flag so signalled
            # completions wake us instantly.
            has_poll = any(e._poll is not None for e in evs)
            any_flag.wait(0.001 if has_poll else remaining)
    finally:
        for e in evs:
            e._remove_callback(wake)
