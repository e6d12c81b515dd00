"""Run one cell of `BENCHMARK.json` once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Needs the port (`src/repro_torch`) beside this
folder and as many CUDA cards as the cell asks for; exits with another code
than 0, printing no result, where either is missing, or where a module of
`jax`, `jaxlib`, `flax` or the JAX package (`repro`) is loaded once the
window has closed. `--trace 0` reports the cell's end-to-end metrics,
`--trace 1` its per-layer ones (from a device trace of the window).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".perfbench_cache"  # build caches: fixed paths inside the checkout


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no port to measure: {ROOT / 'src' / 'repro_torch'} does not exist")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    from perfbench import bench

    cell = bench.workload(args.workload)
    mix = bench.traffic(cell["traffic"])
    bench.set_allocator(mix)

    import torch

    from perfbench.job import Job
    from perfbench.roofline import peaks

    bench.log(f"torch {torch.__version__} imported at {time.perf_counter() - T_START:.1f} s")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        fail(f"{cell['name']} needs {cell['chips']} CUDA card(s); this machine has {n}")
    cfg = bench.config(cell["config"])
    job = Job(cell=cell, config=cfg, traffic=mix, limits=bench.limits(cell["name"]),
              seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device="cuda",
              t_start=T_START)
    torch.cuda.reset_peak_memory_stats()
    out = bench.driver(mix["driver"]).run(job)
    result(job, out, peaks.for_device(torch.cuda.get_device_name(0)),
           torch.cuda.get_device_name(0))


def result(job, out, card_peaks, kind: str) -> None:
    """Assemble and print the result line (`bench.emit`)."""
    from perfbench import bench

    bad = bench.loaded_forbidden()
    if bad:
        fail(f"modules of jax or the JAX package are loaded: {', '.join(bad[:20])}", 3)
    name = job.cell["name"]
    device = {"platform": "gpu", "kind": kind, "count": job.cell["chips"],
              "memory_peak_bytes": out.memory_peak_bytes}
    res = {"correct": bench.judge(out.compared) and out.failed == 0,
           "attempted": out.attempted, "failed": out.failed}
    if job.trace:
        out.ctx.peaks = card_peaks
        res["metrics"] = bench.read_per_layer(out.ctx)
        trace = out.ctx.trace
        device["busy_s"] = trace.busy_s()
        device["window_s"] = trace.window_s
        res["device"] = device
        res["breakdown"] = {"device_ops": bench.top_device_ops(trace),
                            "idle_gaps": bench.idle_gaps(trace, out.ctx.spans)}
    else:
        res["metrics"] = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                          for m in bench.cell_metrics("end_to_end", name)}
        res["device"] = device
    bench.emit(res, out.compared)


if __name__ == "__main__":
    main()
