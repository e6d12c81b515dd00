"""Spans on the host clock: where the port's host time goes, layer by layer.

One recorder for the process, off by default. `start()` clears it and turns
it on; `stop()` turns it off and returns the spans recorded since. While it
is on, each ``with span(name, **meta):`` records a `Span`: an id, the id of
the span open around it on the same thread (0 at the top), the thread,
start and end on `time.perf_counter()` (the clock the benchmark puts the
device trace on), and `meta`. While it is off, `span()` returns the shared
`NO_SPAN`, which reads no clock and records nothing: that flag check is the
whole cost on the hot path.

Meta holds ints, floats, strings and tuples or lists of them, never a
tensor, so the recorder keeps nothing of a step's state alive. A span is
false when tracing is off, so meta that takes work to gather is gathered
under ``if sp:`` and added with ``sp.note(...)``.

The spans (name: meta), by layer:

* runtime, `backends/torchdev.py`: ``unit.enqueue`` {unit} around an
  execution unit's call, ``unit.wait`` {unit} around the wait for its
  completion;
* decoder, `serve/batching.py` (paged): ``decoder.prefill``,
  ``decoder.commit``, ``decoder.interval`` around `prefill` /
  `prefill_prefix`, `load` and `run_interval`;
* scheduler, `serve/scheduler.py`: ``sched.admit`` {rid, prompt,
  shared_pages, new_pages, admitted} around `try_admit`; ``sched.step``
  {ticks, slots: [(rid, tokens before, tokens made)], finished: [rid]}
  around `step`, with ``sched.grow`` and ``sched.harvest`` inside;
* train step, `train/train_step.py` and `train/optimizer.py`:
  ``train.step`` {tokens} around a step, ``train.forward`` and
  ``train.backward`` {micro} once a microbatch, then ``train.clip`` and
  ``train.update``.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List

__all__ = ["NO_SPAN", "Span", "span", "start", "stop"]

#: the clock every span reads (the benchmark's device trace is put on it)
clock = time.perf_counter


class _NoSpan:
    """What `span()` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def note(self, **meta) -> None:
        pass


NO_SPAN = _NoSpan()


class Span:
    """One recorded interval. `parent` is 0 for a span with none open
    around it on its thread."""

    __slots__ = ("name", "meta", "id", "parent", "thread", "start", "end")

    def __init__(self, name: str, meta: dict):
        self.name = name
        self.meta = meta
        self.id = self.parent = self.thread = 0
        self.start = self.end = 0.0

    def note(self, **meta) -> None:
        """Add meta, recorded with the span when it closes."""
        self.meta.update(meta)

    def __enter__(self) -> "Span":
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else 0
        self.thread = threading.get_ident()
        stack.append(self)
        self.start = clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = clock()
        _stack().pop()
        _spans.append(self)
        return False

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"{self.seconds * 1e3:.3f} ms, {self.meta})")


_on = False
_spans: List[Span] = []
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> List[Span]:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, **meta):
    """A context manager recording `name` with `meta` while tracing is on;
    the shared `NO_SPAN` while it is off."""
    if not _on:
        return NO_SPAN
    return Span(name, meta)


def start() -> None:
    """Clear the recorder and turn it on."""
    global _on, _spans
    _spans = []
    _on = True


def stop() -> List[Span]:
    """Turn the recorder off and return the spans closed since `start()`,
    in the order they closed."""
    global _on, _spans
    _on = False
    out, _spans = _spans, []
    return out
