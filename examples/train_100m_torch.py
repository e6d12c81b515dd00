"""End-to-end training driver of the PyTorch port: a ~100M-parameter dense
LM trained on one NVIDIA GPU with the full substrate -- the HiCR launcher,
the SPMD compute manager, the prefetching data pipeline, atomic
checkpoints, resume. Port of `examples/train_100m.py`.

    # quick demo on the card:
    PYTHONPATH=src python examples/train_100m_torch.py --steps 30

    # the full few-hundred-step run:
    PYTHONPATH=src python examples/train_100m_torch.py --steps 300

    # on the CPU (the kernels' plain versions stand in for the CUDA kernels):
    PYTHONPATH=src python examples/train_100m_torch.py --device cpu --steps 2 --batch 1 --seq 16

Interrupt it at any point and re-run: it resumes from the latest committed
checkpoint, data stream included, reproducing the uninterrupted trajectory
(tests/test_torch_examples_train.py holds 4 steps straight against 2 + resume
+ 2, bit for bit on the CPU).

The train step is an execution unit of `backends/spmd.py`'s compute
manager over a (world, 1) ("data", "model") mesh: an NCCL world of one on
the card, gloo with ``--device cpu``. The parameters stay plain tensors, as
the reference's do (`make_train_step` without a mesh), so no DTensor
dispatch is paid; `sharding.ambient.constrain` leaves plain tensors as they
are. The model's head_dim is 80: every attention, forward and backward, runs
the flash kernels' `tf32x3` variant on the card (fp32 on the tensor cores as
three TF32 products a product).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Callable, List, Optional

import torch

from repro_torch.backends import spmd, torchdev
from repro_torch.configs import ArchConfig, ShapeConfig, get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.train import init_world
from repro_torch.models import build
from repro_torch.models.model_zoo import param_count
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.data import DataState, PrefetchingLoader, SyntheticTokenStream
from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
from repro_torch.train.tree import tree_map


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "train_100m_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def model_config() -> ArchConfig:
    """~100M parameters: the gemma3 family at d_model 640, 10 layers, a 50k
    vocabulary, fp32 compute (the reference's widths)."""
    return get_config("gemma3-1b", reduced=True).replace(
        num_layers=10, d_model=640, num_heads=8, num_kv_heads=2, head_dim=80,
        d_ff=2560, vocab_size=50304, sliding_window=256, global_interval=5,
        compute_dtype="float32",
    )


def optimizer_config(steps: int) -> opt_lib.OptimizerConfig:
    return opt_lib.OptimizerConfig(name="adamw", learning_rate=3e-4, warmup_steps=20,
                                   decay_steps=max(steps, 100))


@dataclasses.dataclass
class TrainRun:
    params: dict
    opt_state: dict
    #: one dict a step run: step, loss, grad_norm, lr, seconds (the step's
    #: wall time to its completion on the device)
    history: List[dict]
    start_step: int


def train(cfg: ArchConfig, params, device: torch.device, *, steps: int, batch: int,
          seq: int, ckpt_dir: Optional[str] = None, ckpt_every: int = 25,
          out: Callable[[str], None] = print) -> TrainRun:
    """Train `params` (fp32 masters of `cfg` on `device`) up to step `steps`
    on the synthetic stream, resuming from `ckpt_dir`'s latest committed step
    when it has one (its parameters then replace `params`), and committing a
    checkpoint every `ckpt_every` steps. Starts the process group of one
    when none exists and destroys what it started."""
    import torch.distributed as dist

    model = build(cfg)
    shape = ShapeConfig("train100m", seq_len=seq, global_batch=batch, kind="train")
    ocfg = optimizer_config(steps)
    params, opt_state, ef = init_train_state(model, ocfg, device=device, params=params)
    stream = SyntheticTokenStream(cfg, shape)
    start_step = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        restored, extra = ckpt.restore(ckpt_dir)
        params = tree_map(lambda t: t.to(device), restored["params"])
        opt_state = tree_map(lambda t: t.to(device), restored["opt"])
        stream.state = DataState.from_dict(extra["data"])
        start_step = int(extra["step"])
        out(f"resumed from checkpoint at step {start_step}")

    # HiCR: the train step is an ExecutionUnit on the SPMD compute manager
    own_world = not dist.is_initialized()
    rank, world, _ = init_world(device.type)
    cpm = spmd.SpmdComputeManager(make_mesh((world, 1), ("data", "model"),
                                            device_type=device.type))
    pu = cpm.create_processing_unit(cpm.mesh_compute_resource())
    cpm.initialize(pu)
    unit = cpm.create_execution_unit(make_train_step(model, ocfg, TrainConfig()),
                                     name="train_step")
    loader = PrefetchingLoader(stream, depth=2, workers=2).start()
    history = []
    t0 = time.time()
    try:
        for step in range(start_step, steps):
            data = loader.next_batch()
            t_step = time.perf_counter()
            state = cpm.create_execution_state(unit, params, opt_state, ef, data)
            # the Future resolves once the step's work on the device is done
            params, opt_state, ef, metrics = cpm.execute(pu, state).result()
            history.append({"step": step + 1, "seconds": time.perf_counter() - t_step,
                            **{k: float(metrics[k]) for k in ("loss", "grad_norm", "lr")}})
            if (step + 1) % 5 == 0:
                tok_s = batch * seq * 5 / (time.time() - t0)
                out(f"step {step + 1:4d}  loss={history[-1]['loss']:.4f}  "
                    f"grad_norm={history[-1]['grad_norm']:.3f}  tok/s={tok_s:,.0f}")
                t0 = time.time()
            if ckpt_dir and (step + 1) % ckpt_every == 0 and rank == 0:  # replicas agree
                path = ckpt.save(ckpt_dir, step + 1, {"params": params, "opt": opt_state},
                                 extra={"data": stream.state.to_dict(), "step": step + 1})
                out(f"checkpoint committed: {path}")
    finally:
        loader.stop()
        cpm.finalize(pu)
        if own_world:
            dist.destroy_process_group()
    return TrainRun(params, opt_state, history, start_step)


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    device = torchdev.resolve_device(args.device)  # no card: raises, unless --device cpu
    cfg = model_config()
    params = build(cfg).init(seed=0, device=device)
    print(f"model: {param_count(params) / 1e6:.1f}M parameters "
          f"({cfg.num_layers}L d={cfg.d_model} ff={cfg.d_ff} V={cfg.vocab_size})", flush=True)
    run = train(cfg, params, device, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                out=lambda line: print(line, flush=True))
    print("done.", flush=True)
    return run


if __name__ == "__main__":
    main()
