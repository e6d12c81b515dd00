"""The readings that a cell's limits (`limits/<cell>.json`) are set from,
in one process on the chip: the program's compared numbers on many seeds
(each a set-up and a short window at the cell's own load), and on a few of
them the control's and the faults' readings.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 1,2,3 [--seconds 10]

The control is the plain reference put in the program's place and computed
in float8 (e4m3) products, the precision below the bfloat16 the configs
state. A serving cell's control reads, at each position of the same prompts
and served tokens, the reference's gap to the token that the fp8 control
puts first. A training cell's control runs the fp8 reference's steps; its
faults are half of each batch left out (the mean over the other half) in
the reference put in the program's place, and a step that leaves its state
unchanged, whose change gap is 1 by its definition and needs no run. One
JSON line a seed; the benchmark's own runs never run this.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def serve_readings(job, control: bool) -> dict:
    from perfbench.drivers import serve_closed_loop as d

    out, flat, ended = d.serve(job)
    sample = d.check_sample(ended, job.seed, job.traffic["check"]["served_tokens"])
    row = {"served_tokens": sum(len(r.tokens) for r in sample),
           "logit_gap": d.widest_gap(job.ref_arch(), flat, sample, job.device)}
    if control:
        row["control.logit_gap"] = d.widest_gap(job.ref_arch(), flat, sample, job.device, "fp8")
    del out, flat, ended, sample
    return row


def train_readings(job, control: bool) -> dict:
    from perfbench.drivers import train_steps as d

    n = job.traffic["check_steps"]
    out, prog = d.train(job)
    del out
    gc.collect()
    ref = d.reference_readings(job, n)
    row = {k: v for k, (v, _) in d.compare(job.limits, prog, ref).items()}
    if control:
        for name, kw in (("control", {"precision": "fp8"}),
                         ("half_batch", {"rows": range(job.traffic["batch"] // 2)})):
            got = d.reference_readings(job, n, **kw)
            row.update({f"{name}.{k}": v for k, (v, _) in d.compare(job.limits, got, ref).items()})
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    from perfbench import bench

    cell = bench.workload(args.workload)
    mix = bench.traffic(cell["traffic"])
    bench.set_allocator(mix)

    import torch

    from perfbench.job import Job

    if not torch.cuda.is_available():
        sys.exit("perfbench: calibrate needs a CUDA card")
    readings = {"serve_closed_loop": serve_readings, "train_steps": train_readings}[mix["driver"]]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        job = Job(cell=cell, config=bench.config(cell["config"]), traffic=mix,
                  limits=bench.limits(cell["name"]), seed=seed, seconds=args.seconds, trace=False,
                  device="cuda", t_start=time.perf_counter())
        row = readings(job, seed in control)
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, **row}), flush=True)


if __name__ == "__main__":
    main()
