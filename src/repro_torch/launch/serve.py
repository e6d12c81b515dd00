"""Serving entry point of the port: init seeded weights on the device and
serve a synthetic workload through the serial engine or the
continuous-batching scheduler (dense per-slot caches, or the paged KV pool
with its device-resident decode loop), on a registry-built `torchdev`
Runtime.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --mode continuous --kv-mode dense --max-batch 8 --requests 16 \
        --prompt-len 512 --steps 64
    # paged KV pool: --kv-mode paged [--page-size 16 --sync-interval 8]
    # serial engine, one request at a time: --mode serial

Runs on the CUDA device; ``--device cpu`` runs on the CPU instead (the
kernels' plain PyTorch versions then stand in for the CUDA kernels). The
reference's fleet mode and its prefix cache are not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.runtime import Runtime
from repro_torch.kernels import ops
from repro_torch.models import build
from repro_torch.models.common import dtype_of
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler
from repro_torch.serve.workload import synthetic_requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=("serial", "continuous"), default="continuous")
    ap.add_argument("--kv-mode", choices=("dense", "paged"), default="dense",
                    help="continuous mode: dense per-slot caches, or the paged "
                    "KV pool + device-resident decode loop")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="weight and workload seed")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV pool page size in cache positions (paged mode)")
    ap.add_argument("--sync-interval", type=int, default=8,
                    help="device decode ticks per host sync (paged mode)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="physical KV pool pages (default: every slot can "
                    "hold a full-length sequence)")
    ap.add_argument("--max-batch", type=int, default=8, help="scheduler slots (continuous mode)")
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
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if args.mode == "serial":
            engine = ServeEngine(model, params, max_len=max_len, runtime=runtime)
            for r in requests:
                result = engine.generate(np.asarray([r.prompt], dtype=np.int32),
                                         steps=r.max_new_tokens)
                print(f"{r.rid}: {result.tokens[0][:8].tolist()}...")
        else:
            sched = ContinuousBatchingScheduler(
                model, params, max_batch=args.max_batch, max_len=max_len, runtime=runtime,
                kv_mode=args.kv_mode, page_size=args.page_size,
                pool_pages=args.pool_pages, sync_interval=args.sync_interval,
            )
            results = sched.serve(requests)
            for r in requests:
                fin = results[r.rid]
                print(f"{fin.rid}: {fin.tokens[:8]}... ({fin.finish_reason})")
            print(f"scheduler: {sched.ticks} decode ticks for {len(requests)} requests "
                  f"(kv_mode={args.kv_mode})")
            if args.kv_mode == "paged":
                prog = sched.active_progress()
                print(f"kv pool: {prog.pages_used} pages used / {prog.pages_free} free "
                      f"after drain")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        total_tokens = sum(r.max_new_tokens for r in requests)
        print(f"kernel launches: {ops.launch_counts()}")
        print(f"served {len(requests)} requests / {total_tokens} tokens in {dt:.2f}s "
              f"({total_tokens / dt:.1f} tok/s, mode={args.mode}, device={device})")


if __name__ == "__main__":
    main()
