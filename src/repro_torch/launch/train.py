"""Training entry point of the port. Port of `repro/launch/train.py`.

The launcher path is HiCR's: the port's `torchdev` topology manager finds
the device, its compute manager makes a processing unit of it, and each
train step is an execution unit run on that processing unit, whose Future
yields the step's results. Checkpoints commit atomically and training
resumes from the latest one, the data stream's state included.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --steps 20 --batch 4 --seq 1024 --log-every 5
    # REDUCED on the CPU, with checkpoints:
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
        --steps 4 --ckpt-dir /tmp/run1 --ckpt-every 2

Runs on the CUDA device; ``--device cpu`` runs on the CPU instead (the
kernels' plain PyTorch versions then stand in for the CUDA kernels).
Parameters are seeded fp32 masters; compute follows the config's dtype.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.backends import torchdev
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.models import build
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.data import DataState, SyntheticTokenStream
from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
from repro_torch.train.tree import tree_map


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def train(args: argparse.Namespace, *, grads_hook=None):
    """Train as `args` (`parse_args`) say. Returns (params, opt_state,
    history): the final parameters and optimizer state, and one dict a
    step ({"step", "loss", "grad_norm", "lr", "seconds"}: the step's wall
    time to its completion on the device). `grads_hook` sees every step's
    gradient tree (`train_step.make_train_step`)."""
    cfg = get_config(args.arch, reduced=args.reduced)
    shape = ShapeConfig("cli", seq_len=args.seq, global_batch=args.batch, kind="train")
    model = build(cfg)
    ocfg = opt_lib.OptimizerConfig(
        name=args.optimizer, learning_rate=args.lr, warmup_steps=20,
        decay_steps=max(args.steps, 100),
    )
    tcfg = TrainConfig(microbatches=args.microbatches)

    # ---- HiCR launcher: topology -> compute manager -> processing unit -----
    topology = torchdev.TorchTopologyManager(args.device).query_topology()
    cpm = torchdev.TorchComputeManager(args.device)
    pu = cpm.create_processing_unit(topology.all_compute_resources()[0])
    cpm.initialize(pu)
    device = pu.context
    print(f"training {cfg.name}{' (REDUCED)' if args.reduced else ''} on {device}: "
          f"batch {args.batch} x {args.seq} tokens, {args.optimizer}", flush=True)

    params, opt_state, ef = init_train_state(model, ocfg, device=device, train_cfg=tcfg)
    stream = SyntheticTokenStream(cfg, shape)
    start_step = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        restored, extra = ckpt.restore(args.ckpt_dir)
        to_device = lambda t: t.to(device)  # noqa: E731
        params = tree_map(to_device, restored["params"])
        opt_state = tree_map(to_device, restored["opt"])
        stream.state = DataState.from_dict(extra["data"])
        start_step = int(extra["step"])
        print(f"resumed from step {start_step}", flush=True)

    unit = cpm.create_execution_unit(make_train_step(model, ocfg, tcfg, grads_hook=grads_hook),
                                     name=f"train_step[{args.arch}]")
    history = []
    t0 = time.time()
    tokens_per_step = args.batch * args.seq
    for step in range(start_step, args.steps):
        batch = stream.next_batch()
        t_step = time.perf_counter()
        state = cpm.create_execution_state(unit, params, opt_state, ef, batch)
        # the Future resolves once the step's work on the device is done
        params, opt_state, ef, metrics = cpm.execute(pu, state).result()
        history.append({"step": step + 1, "seconds": time.perf_counter() - t_step,
                        **{k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")}})
        if (step + 1) % args.log_every == 0:
            dt = time.time() - t0
            tps = tokens_per_step * args.log_every / max(dt, 1e-9)
            print(
                f"step {step+1:5d} loss={history[-1]['loss']:.4f} "
                f"grad_norm={history[-1]['grad_norm']:.3f} "
                f"lr={history[-1]['lr']:.2e} tok/s={tps:,.0f}", flush=True
            )
            t0 = time.time()
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(
                args.ckpt_dir, step + 1,
                {"params": params, "opt": opt_state},
                extra={"data": stream.state.to_dict(), "step": step + 1},
            )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    cpm.finalize(pu)
    print("training complete", flush=True)
    return params, opt_state, history


def main(argv=None):
    params, _, _ = train(parse_args(argv))
    return params


if __name__ == "__main__":
    main()
