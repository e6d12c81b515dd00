"""Run one cell's traced window with the port's spans recorded, and print
what they read beside the cell's per-layer metrics.

    python3 perfbench/trace_spans.py --workload <cell> --seed <n> --seconds <s>

From the root of a checkout, on a machine with the cell's CUDA cards. The
harness's drivers open their traced window with `bench.Trace`; this runs the
cell's driver with `program_spans.SpanTrace` in its place, so the port's
recorder is on over the window. It prints one JSON line: the cell's
per-layer metrics as `run.py --trace 1` reads them, the window's end-to-end
numbers, the harness's mean step, the nine readings of
`program_spans.READINGS`, the share of device time tied to a span, each
span's host time and count, and `device_ops_by_span`. The reference that
decides `correct` does not run; `run.py --trace 1` on the same seed is the
same window with the recorder off.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"

#: the function of each driver that runs the program's part of a run
PROGRAM_PART = {"serve_closed_loop": "serve", "train_steps": "train"}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    from perfbench import bench, program_spans

    cell = bench.workload(args.workload)
    mix = bench.traffic(cell["traffic"])
    bench.set_allocator(mix)

    import torch

    from perfbench.job import Job
    from perfbench.roofline import peaks
    from repro_torch.core import tracing

    if not torch.cuda.is_available():
        sys.exit("trace_spans: needs a CUDA card")
    windows = []

    class Kept(program_spans.SpanTrace):
        def stop(self, t1):
            trace = super().stop(t1)
            windows.append(self.window)
            return trace

    bench.Trace = Kept
    job = Job(cell=cell, config=bench.config(cell["config"]), traffic=mix,
              limits=bench.limits(cell["name"]), seed=args.seed, seconds=args.seconds,
              trace=True, device="cuda", t_start=T_START)
    torch.cuda.reset_peak_memory_stats()
    try:
        out = getattr(bench.driver(mix["driver"]), PROGRAM_PART[mix["driver"]])(job)[0]
    finally:
        tracing.stop()
    kind = torch.cuda.get_device_name(0)
    ctx = out.ctx
    ctx.peaks = peaks.for_device(kind)
    steps = [s.seconds for s in ctx.spans if s.name in ("step", "interval")
             and ctx.t0 <= s.start and s.end <= ctx.t1]
    res = {"workload": cell["name"], "seed": args.seed,
           "device": {"kind": kind, "busy_s": ctx.trace.busy_s(), "window_s": ctx.trace.window_s},
           "e2e": out.e2e, "harness_step_s": statistics.mean(steps) if steps else None,
           "metrics": {k: v["value"] for k, v in bench.read_per_layer(ctx).items()}}
    w = windows[0]
    res["spans"] = {name: read(w) for name, read in program_spans.READINGS.items()}
    res["tied_share"] = w.tied_share()
    res["ops_with_launch"] = [sum(op[3] is not None for op in w.ops), len(w.ops)]
    host = defaultdict(lambda: [0.0, 0])
    for s in w.spans:
        if w.t0 <= s.start and s.end <= w.t1:
            key = f"{s.name} {s.meta['unit']}" if "unit" in s.meta else s.name
            host[key][0] += s.seconds
            host[key][1] += 1
    res["span_host_s"] = dict(sorted(host.items(), key=lambda kv: -kv[1][0]))
    res["device_ops_by_span"] = program_spans.device_ops_by_span(w)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
