"""The port's own spans (`repro_torch/core/tracing.py`) in a traced window,
and the device time of the operations each span launched.

`SpanTrace` is `bench.Trace` that also turns the port's recorder on for the
window and ties each device operation to the host call that launched it, by
the CUPTI correlation id the profiler gives both. A `Window` holds what it
read: the port's spans and each device operation with its launch time, all
on the host's `perf_counter` clock. An operation belongs to the innermost
span whose interval holds its launch time; the match goes by time, not by
thread, because the autograd engine launches the backward from a thread of
its own while the step's thread waits inside ``train.backward``.

`READINGS` maps nine per-layer quantities to their reader over a `Window`;
a reader returns None where the window holds nothing to read, and each one
that reads device time first checks that at least `MIN_TIED` of the
window's device time is tied to some span (the harness's own launches, such
as a training batch's draw, fall outside every span).

Nothing in the harness's runs imports this module: the drivers open their
windows with `bench.Trace`, so these readings are taken by a script that
runs a driver with `SpanTrace` in its place (PERF.md).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from perfbench import bench

#: the least share of the window's device time that must lie under a span
MIN_TIED = 0.95

PREFILL_UNITS = ("paged_prefill", "prefix_prefill", "prefill")


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Window:
    """A traced window's program spans (objects with `name`, `start`,
    `end`, `meta`, `id` and `parent`, as `tracing.stop()` returns them) and
    device operations (name, start, end, launch time or None)."""

    spans: Sequence
    ops: Sequence[Tuple[str, float, float, Optional[float]]]
    t0: float
    t1: float

    def __post_init__(self):
        self.by_id = {s.id: s for s in self.spans}
        self._tied: Optional[List[tuple]] = None

    def named(self, name: str, match: Callable[[dict], bool] = lambda meta: True) -> list:
        """The spans called `name` inside the window whose meta `match`es."""
        return [s for s in self.spans if s.name == name and self.t0 <= s.start
                and s.end <= self.t1 and match(s.meta)]

    def tied(self) -> List[tuple]:
        """(innermost span holding the launch or None, op) for each op
        launched inside the window."""
        if self._tied is None:
            self._tied = tie(self.spans, [op for op in self.ops if op[3] is not None
                                          and self.t0 <= op[3] <= self.t1])
            untimed = [(None, op) for op in self.ops if op[3] is None
                       and self.t0 <= op[1] <= self.t1]
            self._tied += untimed
        return self._tied

    def tied_share(self) -> Optional[float]:
        """The share of the window's device seconds launched inside a span."""
        pairs = self.tied()
        total = sum(op[2] - op[1] for _, op in pairs)
        if total <= 0:
            return None
        return sum(op[2] - op[1] for sp, op in pairs if sp is not None) / total

    def within(self, span, match: Callable) -> bool:
        """Whether `span` or a span around it `match`es."""
        while span is not None:
            if match(span):
                return True
            span = self.by_id.get(span.parent)
        return False

    def inside(self, span) -> bool:
        """Whether the outermost span around `span` lies wholly inside the
        window: the rule by which `named` counts ticks, steps and tokens."""
        while span.parent in self.by_id:
            span = self.by_id[span.parent]
        return self.t0 <= span.start and span.end <= self.t1

    def device_s(self, match: Callable) -> float:
        """Device seconds of the ops launched inside a span that `match`es
        (at any depth) and lies `inside` the window."""
        per_span: Dict[int, float] = defaultdict(float)
        for sp, op in self.tied():
            if sp is not None:
                per_span[sp.id] += op[2] - op[1]
        return sum(s for i, s in per_span.items()
                   if self.inside(self.by_id[i]) and self.within(self.by_id[i], match))


def tie(spans: Sequence, ops: Sequence) -> List[tuple]:
    """(innermost span whose [start, end] holds the op's launch time, or
    None; op) for each op, by a sweep in time. Of the spans holding a time,
    the innermost is the one that started last."""
    order = sorted(spans, key=lambda s: s.start)
    out, open_, i = [], [], 0
    for op in sorted(ops, key=lambda o: o[3]):
        t = op[3]
        while i < len(order) and order[i].start <= t:
            open_.append(order[i])
            i += 1
        open_ = [s for s in open_ if s.end >= t]
        out.append((open_[-1] if open_ else None, op))
    return out


def _checked(metric: str, w: Window) -> bool:
    share = w.tied_share()
    if share is None or share < MIN_TIED:
        bench.log(f"{metric}: {share} of the window's device time lies under a program "
                  f"span (needs {MIN_TIED}): not read")
        return False
    return True


def _unit(names) -> Callable:
    return lambda s: s.name == "unit.enqueue" and s.meta.get("unit") in names


def _fused(s) -> bool:
    return s.name == "unit.enqueue" and str(s.meta.get("unit", "")).startswith("fused_decode")


def ticks(w: Window) -> int:
    return sum(s.meta.get("ticks", 0) for s in w.named("sched.step"))


# ---------------------------------------------------------------------------
# the readings
# ---------------------------------------------------------------------------


def dispatch_ms_per_tick(w: Window) -> Optional[float]:
    """Host ms inside the fused decode unit's ``unit.enqueue`` / ticks."""
    n = ticks(w)
    if not n:
        return None
    return sum(s.seconds for s in w.named("unit.enqueue") if _fused(s)) * 1e3 / n


def decode_device_ms_per_tick(w: Window) -> Optional[float]:
    """Device ms of the ops launched inside those spans / ticks."""
    n = ticks(w)
    if not n or not _checked("decode_device_ms_per_tick", w):
        return None
    return w.device_s(_fused) * 1e3 / n


def sched_self_ms_per_tick(w: Window) -> Optional[float]:
    """Host ms of ``sched.step`` outside its ``decoder.interval`` / ticks."""
    n = ticks(w)
    if not n:
        return None
    steps = w.named("sched.step")
    ids = {s.id for s in steps}
    inner = sum(s.seconds for s in w.named("decoder.interval") if s.parent in ids)
    return (sum(s.seconds for s in steps) - inner) * 1e3 / n


def prefill_device_ms_per_ktok(w: Window) -> Optional[float]:
    """Device ms of the ops launched inside the prefill unit's
    ``unit.enqueue`` / thousand prompt tokens admitted."""
    tokens = sum(s.meta["prompt"] for s in w.named("sched.admit", lambda m: m.get("admitted")))
    if not tokens or not _checked("prefill_device_ms_per_ktok", w):
        return None
    return w.device_s(_unit(PREFILL_UNITS)) * 1e3 / (tokens / 1e3)


def idle_launching(w: Window) -> Optional[float]:
    """% of the window the device is idle while the host is inside some
    ``unit.enqueue``."""
    units = w.named("unit.enqueue")
    if not units or not w.ops:
        return None
    busy = bench.merged(w.ops, w.t0, w.t1)
    host = bench.merged([(None, s.start, s.end) for s in units], w.t0, w.t1)
    return (_length(host) - _overlap(host, busy)) * 100.0 / (w.t1 - w.t0)


def _phase_ms(phase: str) -> Callable[[Window], Optional[float]]:
    def read(w: Window) -> Optional[float]:
        steps = len(w.named("train.step"))
        if not steps or not _checked(f"{phase} ms", w):
            return None
        return w.device_s(lambda s: s.name == phase) * 1e3 / steps
    read.__doc__ = f"Device ms a step of the ops launched inside ``{phase}``."
    return read


READINGS: Dict[str, Callable[[Window], Optional[float]]] = {
    "dispatch_ms_per_tick.serve": dispatch_ms_per_tick,
    "decode_device_ms_per_tick.serve": decode_device_ms_per_tick,
    "sched_self_ms_per_tick.serve": sched_self_ms_per_tick,
    "prefill_device_ms_per_ktok.serve": prefill_device_ms_per_ktok,
    "idle_launching.serve": idle_launching,
    "forward_ms.train": _phase_ms("train.forward"),
    "backward_ms.train": _phase_ms("train.backward"),
    "clip_ms.train": _phase_ms("train.clip"),
    "optimizer_ms.train": _phase_ms("train.update"),
}


def device_ops_by_span(w: Window, n: int = 10) -> List[list]:
    """[innermost span (with its unit), device op, device seconds] of the
    `n` pairs that took the most device time."""
    total: Dict[Tuple[str, str], float] = defaultdict(float)
    for sp, op in w.tied():
        label = "none" if sp is None else (
            f"{sp.name} {sp.meta['unit']}" if "unit" in sp.meta else sp.name)
        total[(label, op[0][:120])] += op[2] - op[1]
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[label, name, s] for (label, name), s in top]


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    out, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        out += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------


class SpanTrace(bench.Trace):
    """`bench.Trace` with the port's recorder on over the window. After
    `stop()`: `window`, a `Window` of the port's spans and the device
    operations with their launch times."""

    def start(self) -> float:
        from repro_torch.core import tracing

        tracing.start()
        return super().start()

    def stop(self, t1: float) -> bench.TraceData:
        from repro_torch.core import tracing

        prof = self.prof
        try:
            trace = super().stop(t1)
        finally:
            spans = tracing.stop()
        self.window = Window(spans, with_launch(prof.profiler.kineto_results.events(),
                                                self.torch, self.t0, t1), self.t0, t1)
        return trace


def with_launch(events, torch, t0: float, t1: float) -> List[tuple]:
    """(name, start, end, launch) of each device operation among the
    profiler's `events`, on the `perf_counter` clock; launch is the start of
    the CUDA runtime or driver call with the op's correlation id (None where
    no such call was recorded)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, calls = [], {}
    for e in events:
        if e.device_type() == cuda:
            dev.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.correlation_id()))
        elif e.name().startswith("cu") and e.correlation_id():
            calls[e.correlation_id()] = e.start_ns()
    shift = bench._clock_shift(dev, t0, t1)
    out = []
    for name, s, e, corr in dev:
        launch = calls.get(corr)
        out.append((name, s * 1e-9 - shift, e * 1e-9 - shift,
                    None if launch is None else launch * 1e-9 - shift))
    return out
