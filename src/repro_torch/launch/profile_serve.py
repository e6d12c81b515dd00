"""Where the serving path's time goes on the card: a traced run of the same
workload as `chip_smoke.py`'s serve phases (a full-width model, 8 slots, 16
synthetic requests with 64-1024-token prompts and 16-64 new tokens; paged:
page 16, sync interval 8), under `torch.profiler`.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve [--seed 0] \
        [--arch gemma3-1b|xlstm-125m] [--kv-mode paged|dense]

(xlstm-125m has no paged path: pass ``--kv-mode dense``.)

Prints the untraced wall time of the run, then for the traced run: the
device's busy time (union of kernel intervals) and idle share of the traced
window, the host time of prefill admissions vs decode intervals, and the
kernels with the most device time. Needs a CUDA device. A trace costs host
time per launch, so take end-to-end numbers from the untraced run.
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch

from repro_torch.configs import get_config
from repro_torch.core.runtime import Runtime
from repro_torch.models import build
from repro_torch.models.common import dtype_of
from repro_torch.serve.scheduler import ContinuousBatchingScheduler
from repro_torch.serve.workload import synthetic_requests


def _busy_us(intervals):
    """Total length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--kv-mode", choices=("paged", "dense"), default="paged")
    ap.add_argument("--arch", default="gemma3-1b")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    model = build(cfg)
    with Runtime("torchdev") as rt:
        params = model.init(seed=0, device=rt.processing_unit.context,
                            dtype=dtype_of(cfg.compute_dtype))
        sched = ContinuousBatchingScheduler(
            model, params, max_batch=8, max_len=1088, runtime=rt, kv_mode=args.kv_mode,
            page_size=16, sync_interval=8,
        )
        sched.serve(synthetic_requests(cfg.vocab_size, 2, prompt_range=(64, 65),
                                       steps_range=(9, 10), seed=1, rid_prefix="warm"))

        def workload(prefix):
            return synthetic_requests(cfg.vocab_size, 16, prompt_range=(64, 1025),
                                      steps_range=(16, 65), seed=args.seed, rid_prefix=prefix)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = sched.serve(workload("plain"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_tok = sum(len(f.tokens) for f in results.values())
        print(f"untraced ({args.arch}, {args.kv_mode}): {n_tok} tokens in {wall:.3f}s "
              f"({n_tok / wall:.1f} tok/s)")

        host = defaultdict(float)
        admit, step = sched.try_admit, sched.step

        def timed(name, fn):
            def run(*a):
                s = time.perf_counter()
                out = fn(*a)
                host[name] += time.perf_counter() - s
                return out
            return run

        sched.try_admit, sched.step = timed("admission (prefill + load)", admit), \
            timed("decode steps", step)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            sched.serve(workload("traced"))
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("the profiler recorded no device activity")
        return
    start = min(e.time_range.start for e in kernels)
    end = max(e.time_range.end for e in kernels)
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    print(f"traced: wall {traced:.3f}s; device window {(end - start) / 1e6:.3f}s, busy "
          f"{busy / 1e6:.3f}s, idle share {1 - busy / (traced * 1e6):.3f} of the traced wall")
    for name, sec in host.items():
        print(f"host time in {name}: {sec:.3f}s")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    print(f"top {args.top} kernels by device time:")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[: args.top]:
        print(f"  {us / 1e3:9.2f} ms  {n:6d} launches  {name[:110]}")


if __name__ == "__main__":
    main()
