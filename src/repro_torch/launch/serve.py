"""Serving entry point of the port: init seeded weights on the device (or
read them from a checkpoint in the reference's layout) and serve a
synthetic workload through the serial engine or the continuous-batching
scheduler (dense per-slot caches, or the paged KV pool with its
device-resident decode loop and, optionally, the prefix cache), on a
registry-built `torchdev` Runtime.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --mode continuous --kv-mode dense --max-batch 8 --requests 16 \
        --prompt-len 512 --steps 64
    # paged KV pool: --kv-mode paged [--page-size 16 --sync-interval 8]
    # prefix cache over the pool: --kv-mode paged --prefix-cache --prefix-share 0.5
    # serial engine, one request at a time: --mode serial
    # weights from `repro/train/checkpoint.py`'s layout: --ckpt-dir DIR
    # the hybrid family: --arch zamba2-7b (dense or serial)
    # the dense family: --arch granite-20b | minitron-8b | stablelm-12b

    # data-parallel fleet: router + N worker instances (paper §3.1.1), each
    # worker a localsim thread running its own scheduler on the shared weights
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --mode fleet --workers 2 --max-batch 4 --requests 16

Runs on the CUDA device; ``--device cpu`` runs on the CPU instead (the
kernels' plain PyTorch versions then stand in for the CUDA kernels).
``--kv-mode`` and ``--prefix-cache`` apply per worker in fleet mode.
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
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.common import dtype_of
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import ContinuousBatchingScheduler
from repro_torch.serve.workload import shared_prefix_requests, synthetic_requests
from repro_torch.train import checkpoint as ckpt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=("serial", "continuous", "fleet"), default="continuous")
    ap.add_argument("--workers", type=int, default=2,
                    help="fleet mode: worker instances spawned by the router")
    ap.add_argument("--msg-size", type=int, default=None,
                    help="fleet mode: channel message size in bytes (default: "
                    "sized to fit the workload's longest possible request)")
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
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged mode: refcounted radix prefix cache; shared prompt "
                    "prefixes are forked by page reference and only the uncached "
                    "tail is prefilled")
    ap.add_argument("--prefix-share", type=float, default=0.0,
                    help="fraction of requests opening with a shared system prompt "
                    "(the workload prefix caching exists for); 0 keeps the fully "
                    "unique synthetic workload")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="scheduler slots (continuous mode; per worker in fleet mode)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--ckpt-dir", default=None,
                    help="read the weights from the latest committed step under this "
                    "directory (the reference's checkpoint layout)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    model = build(cfg)
    with Runtime("torchdev", device=args.device) as runtime:
        device = runtime.processing_unit.context
        # matrices stored once in the compute dtype: every use casts to it
        cd = dtype_of(cfg.compute_dtype)
        if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
            restored, _ = ckpt.restore(args.ckpt_dir)
            params = params_from_jax(cfg, restored["params"], device=device, dtype=cd)
            print(f"restored weights from {args.ckpt_dir}")
        else:
            params = model.init(seed=args.seed, device=device, dtype=cd)
        max_len = args.prompt_len + args.steps
        if args.prefix_share > 0:
            requests = shared_prefix_requests(
                cfg.vocab_size,
                args.requests,
                prefix_len=max(1, args.prompt_len // 2),
                prefix_share=args.prefix_share,
                tail_range=(1, max(2, args.prompt_len // 2 + 1)),
                steps_range=(max(1, args.steps // 2), args.steps + 1),
                seed=args.seed,
            )
        else:
            requests = synthetic_requests(
                cfg.vocab_size,
                args.requests,
                prompt_range=(max(1, args.prompt_len // 2), args.prompt_len + 1),
                steps_range=(max(1, args.steps // 2), args.steps + 1),
                seed=args.seed,
            )
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if args.mode == "fleet":
            from repro_torch.serve.router import run_fleet

            # default msg_size: room for the longest admissible request wire
            # (~6 bytes per prompt token + JSON framing), rounded up
            msg_size = args.msg_size or max(512, 128 + 8 * max_len)
            out = run_fleet(
                model, params, requests, n_workers=args.workers,
                max_batch=args.max_batch, max_len=max_len, msg_size=msg_size,
                kv_mode=args.kv_mode, page_size=args.page_size,
                pool_pages=args.pool_pages, sync_interval=args.sync_interval,
                prefix_cache=args.prefix_cache, device=str(device),
            )
            for r in requests:
                res = out.results[r.rid]
                if "error" in res:
                    print(f"{r.rid}: ERROR {res['error']}")
                else:
                    print(f"{r.rid}: {res['tokens'][:8]}... ({res['finish_reason']})")
            stats = out.stats
            print(f"fleet: {stats['workers_spawned']} workers, per-worker settled "
                  f"{stats['per_worker_settled']}, restarted {stats['restarted']}")
            if args.prefix_cache:
                for idx, pstats in sorted(stats.get("per_worker_prefix", {}).items()):
                    if pstats:
                        print(f"  worker {idx} prefix cache: hit_rate="
                              f"{pstats['hit_rate']:.2f} cached_pages="
                              f"{pstats['cached_pages']}")
        elif args.mode == "serial":
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
                prefix_cache=args.prefix_cache,
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
                if prog.prefix is not None:
                    print(f"prefix cache: hit_rate={prog.prefix['hit_rate']:.2f} "
                          f"({prog.prefix['hits']}/{prog.prefix['lookups']} requests, "
                          f"{prog.prefix['hit_tokens']}/{prog.prefix['queried_tokens']}"
                          f" tokens), {prog.prefix['cached_pages']} cached pages, "
                          f"{prog.prefix['evictions']} evictions")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        total_tokens = sum(r.max_new_tokens for r in requests)
        print(f"kernel launches: {ops.launch_counts()}")
        print(f"served {len(requests)} requests / {total_tokens} tokens in {dt:.2f}s "
              f"({total_tokens / dt:.1f} tok/s, mode={args.mode}, device={device}"
              + (f", workers={args.workers})" if args.mode == "fleet" else ")"))


if __name__ == "__main__":
    main()
