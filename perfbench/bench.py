"""What every cell shares: finding a cell's files by name, the harness's own
spans, the device trace of a window and its reduction, percentiles, and the
result line.

Times are host `time.perf_counter()` seconds throughout. The profiler's
timestamps are put on that clock once its window is read (`Trace.stop`).
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PB = Path(__file__).resolve().parent
ROOT = PB.parent

#: top-level module names that no run may have loaded once its window closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


# ---------------------------------------------------------------------------
# files found by name
# ---------------------------------------------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _entry(entries: Sequence[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(name: str, root: Path = ROOT) -> dict:
    return _entry(benchmark(root)["workloads"], name, "workload")


def config(name: str, root: Path = ROOT) -> dict:
    entry = _entry(benchmark(root)["configs"], name, "config")
    return load_json(root / entry["file"])


def _data_file(folder: Path, name: str) -> Path:
    path = folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    return path


def traffic(name: str, root: Path = ROOT) -> dict:
    return load_json(_data_file(root / "perfbench" / "traffic", name))


def limits(workload_name: str, root: Path = ROOT) -> dict:
    return load_json(_data_file(root / "perfbench" / "limits", workload_name))


def set_allocator(mix: dict) -> None:
    """A mix's `cuda_alloc_conf` (PyTorch's caching allocator settings, as
    a deployment of that workload sets them) into the environment; before
    torch is imported."""
    if "cuda_alloc_conf" in mix:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = mix["cuda_alloc_conf"]


def driver(kind: str):
    return importlib.import_module(f"perfbench.drivers.{kind}")


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """`read(ctx)` of `metrics/<name>.py` (a metric's name may hold dots, so
    the file is loaded by its path)."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(section: str, cell: str, root: Path = ROOT) -> List[dict]:
    """The `end_to_end` or `per_layer` entries that `cell` reports: those
    that list it under `workloads`, and those with no `workloads` key."""
    return [m for m in benchmark(root)[section]
            if "workloads" not in m or cell in m["workloads"]]


# ---------------------------------------------------------------------------
# spans and statistics
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Span:
    """One interval of the harness's own, around a call into the program."""

    name: str
    start: float
    end: float
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def spans_in(spans: Sequence[Span], name: str, t0: float, t1: float) -> List[Span]:
    return [s for s in spans if s.name == name and s.start >= t0 and s.end <= t1]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile with linear interpolation between the two nearest
    ranks (numpy's default); NaN of no values."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


# ---------------------------------------------------------------------------
# the device trace of a window
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceData:
    """Device operations (kernels, copies, sets) and host launch calls of a
    traced window, on the host's `perf_counter` clock."""

    device_ops: List[Tuple[str, float, float]]
    host_calls: List[Tuple[str, float, float]]
    t0: float
    t1: float

    def ops_named(self, match: Callable[[str], bool]) -> List[Tuple[str, float, float]]:
        return [op for op in self.device_ops if match(op[0])]

    def busy_s(self) -> float:
        return sum(e - s for s, e in merged(self.device_ops, self.t0, self.t1))

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def merged(ops, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The union of the ops' intervals, clipped to [t0, t1], as disjoint
    (start, end) pairs in order."""
    out: List[List[float]] = []
    for s, e in sorted((max(o[1], t0), min(o[2], t1)) for o in ops):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def is_launch(name: str) -> bool:
    return "LaunchKernel" in name or "LaunchCooperativeKernel" in name


class Trace:
    """`torch.profiler` over a window, device activity only (the host's own
    operators are not recorded: they would slow the host, which paces the
    decode path). `stop()` returns the window's `TraceData`."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = 0.0

    def start(self) -> float:
        tp = self.torch.profiler
        self.prof = tp.profile(activities=[tp.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self.t0

    def stop(self, t1: float) -> TraceData:
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        cuda = self.torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in events:
            row = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == cuda:
                dev.append(row)
            elif is_launch(row[0]):
                host.append(row)
        self.prof = None
        shift = _clock_shift(dev + host, self.t0, t1)
        conv = lambda rows: [(n, s * 1e-9 - shift, e * 1e-9 - shift) for n, s, e in rows]  # noqa: E731
        return TraceData(device_ops=conv(dev), host_calls=conv(host), t0=self.t0, t1=t1)


def _clock_shift(rows, t0: float, t1: float) -> float:
    """Seconds to subtract from the profiler's timestamps to put them on the
    `perf_counter` clock. The profiler stamps wall-clock (realtime) time on
    most builds and the monotonic clock on some: take whichever puts the
    most of the events inside the window."""
    real = time.time_ns() * 1e-9 - time.perf_counter()
    mono = time.monotonic_ns() * 1e-9 - time.perf_counter()
    if not rows:
        return real
    starts = [r[1] * 1e-9 for r in rows[:: max(1, len(rows) // 2000)]]

    def inside(shift):
        return sum(t0 - 1 <= s - shift <= t1 + 1 for s in starts)

    return max((real, mono), key=inside)


def top_device_ops(trace: TraceData, n: int = 10) -> List[list]:
    """[name, seconds] of the `n` device operations that took the most time
    in the window, summed over their calls."""
    total: Dict[str, float] = {}
    for name, s, e in trace.device_ops:
        s, e = max(s, trace.t0), min(e, trace.t1)
        if e > s:
            total[name] = total.get(name, 0.0) + (e - s)
    return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(trace: TraceData, spans: Sequence[Span], n: int = 10) -> List[list]:
    """[what the host was doing, seconds] of the device's idle time in the
    window, summed by that label, the largest `n`. A gap is labelled by the
    harness span around its middle and by the last host launch call before
    its end (or "no launch")."""
    busy = merged(trace.device_ops, trace.t0, trace.t1)
    gaps, cur = [], trace.t0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if trace.t1 > cur:
        gaps.append((cur, trace.t1))
    ordered = sorted(spans, key=lambda sp: sp.start)
    starts = [sp.start for sp in ordered]
    calls = sorted(trace.host_calls, key=lambda c: c[1])
    call_starts = [c[1] for c in calls]
    total: Dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        where = ordered[i].name if i >= 0 and ordered[i].end >= mid else "harness"
        j = bisect.bisect_right(call_starts, e) - 1
        last = calls[j][0] if j >= 0 and calls[j][1] >= s else "no launch"
        label = f"{where}: {last}"
        total[label] = total.get(label, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


# ---------------------------------------------------------------------------
# the context a per-layer reader sees
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReadContext:
    """What a per-layer metric's reader may read: the cell, its config and
    traffic, the arch the program ran, the window [t0, t1], the harness's
    spans, the program's kernel launch counts over the window
    (`ops.launch_counts()`), the device trace (None without one) and the
    device's peaks (None on an unknown device)."""

    cell: str
    config: dict
    traffic: dict
    arch: object
    t0: float
    t1: float
    spans: List[Span]
    counters: dict
    trace: Optional[TraceData]
    peaks: Optional[dict]


def read_per_layer(ctx: ReadContext, root: Path = ROOT) -> Dict[str, dict]:
    out = {}
    for m in cell_metrics("per_layer", ctx.cell, root):
        value = metric_reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------


def log(msg: str) -> None:
    """A progress line on standard error."""
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def loaded_forbidden() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


def emit(result: dict, compared: Dict[str, Tuple[float, float]]) -> None:
    """Print each compared number beside its limit as the last lines on
    standard error, then the result line (with the same under `compared`,
    its last key) as the last line of standard output."""
    result = dict(result)
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def judge(compared: Dict[str, Tuple[float, float]]) -> bool:
    """Correct when every compared number is finite and within its limit."""
    return all(math.isfinite(v) and v <= lim for v, lim in compared.values())
