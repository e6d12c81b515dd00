"""Serving entry point of the port: init seeded weights on the device and
serve a synthetic workload through the continuous-batching scheduler over
the paged KV pool, on a registry-built `torchdev` Runtime.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --kv-mode paged --max-batch 8 --requests 16 --prompt-len 512 --steps 64

Runs on the CUDA device; ``--device cpu`` runs on the CPU instead (the
kernels' plain PyTorch versions then stand in for the CUDA kernels). The
reference's serial and fleet modes and its dense KV mode are not ported yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.runtime import Runtime
from repro_torch.kernels import ops
from repro_torch.models import build
from repro_torch.models.common import dtype_of
from repro_torch.serve.scheduler import ContinuousBatchingScheduler
from repro_torch.serve.workload import synthetic_requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=("continuous",), default="continuous")
    ap.add_argument("--kv-mode", choices=("paged",), default="paged",
                    help="paged KV pool + device-resident decode loop")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="weight and workload seed")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV pool page size in cache positions")
    ap.add_argument("--sync-interval", type=int, default=8,
                    help="device decode ticks per host sync")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="physical KV pool pages (default: every slot can "
                    "hold a full-length sequence)")
    ap.add_argument("--max-batch", type=int, default=8, help="scheduler slots")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    model = build(cfg)
    with Runtime("torchdev", device=args.device) as runtime:
        device = runtime.processing_unit.context
        # matrices stored once in the compute dtype: every use casts to it
        params = model.init(seed=args.seed, device=device, dtype=dtype_of(cfg.compute_dtype))
        max_len = args.prompt_len + args.steps
        requests = synthetic_requests(
            cfg.vocab_size,
            args.requests,
            prompt_range=(max(1, args.prompt_len // 2), args.prompt_len + 1),
            steps_range=(max(1, args.steps // 2), args.steps + 1),
            seed=args.seed,
        )
        sched = ContinuousBatchingScheduler(
            model, params, max_batch=args.max_batch, max_len=max_len, runtime=runtime,
            kv_mode=args.kv_mode, page_size=args.page_size,
            pool_pages=args.pool_pages, sync_interval=args.sync_interval,
        )
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results = sched.serve(requests)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        total_tokens = sum(len(fin.tokens) for fin in results.values())
        for r in requests:
            fin = results[r.rid]
            print(f"{fin.rid}: {fin.tokens[:8]}... ({fin.finish_reason})")
        print(f"scheduler: {sched.ticks} decode ticks for {len(requests)} requests "
              f"(kv_mode={args.kv_mode})")
        prog = sched.active_progress()
        print(f"kv pool: {prog.pages_used} pages used / {prog.pages_free} free after drain")
        print(f"kernel launches: {ops.launch_counts()}")
        print(f"served {len(requests)} requests / {total_tokens} tokens in {dt:.2f}s "
              f"({total_tokens / dt:.1f} tok/s, device={device})")


if __name__ == "__main__":
    main()
