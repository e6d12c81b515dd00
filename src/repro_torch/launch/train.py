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

Multi-device (the reference's route): under ``torchrun`` (``WORLD_SIZE``
set) or with ``--mesh DxM``, the process group comes from the environment
(NCCL on ``cuda``, gloo for ``--device cpu``; a lone process with
``--mesh 1x1`` is a world of one), every rank's `torchdev` topology is
gathered into the world's (`discover_mesh`), `launch/mesh.py::
mesh_from_topology` sizes the ("data", "model") mesh from it, and the step
runs as an SPMD program through the `spmd` compute manager over DTensors
placed by the sharding plan:

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch gemma3-1b --mesh 4x2
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --mesh 1x1 --steps 3
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import time

import torch

from repro_torch.backends import spmd, torchdev
from repro_torch.core.stateless import Topology
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.models import build
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.data import DataState, SyntheticTokenStream
from repro_torch.train.train_step import (
    TrainConfig,
    init_train_state,
    make_train_step,
    shard_train_state,
)
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
    ap.add_argument("--mesh", default=None,
                    help="DxM: ('data', 'model') sizes; takes the SPMD route (as WORLD_SIZE does)")
    return ap.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(device: str):
    """The default process group from the environment (``torchrun``'s
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT; a lone process is rank 0
    of one at 127.0.0.1 on a free port): NCCL on ``cuda``, gloo on ``cpu``.
    Returns (rank, world size, this rank's device). A failed init raises."""
    import torch.distributed as dist

    if not dist.is_initialized():
        env = os.environ
        rank, world = int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1))
        addr = env.get("MASTER_ADDR", "127.0.0.1")
        port = env.get("MASTER_PORT") or str(_free_port())
        kw = dict(init_method=f"tcp://{addr}:{port}", rank=rank, world_size=world)
        if device == "cuda":
            local = int(env.get("LOCAL_RANK", rank))
            torch.cuda.set_device(local)
            dist.init_process_group("nccl", device_id=torch.device("cuda", local), **kw)
        else:
            dist.init_process_group("gloo", **kw)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" \
        else torch.device("cpu")
    return dist.get_rank(), dist.get_world_size(), dev


def discover_mesh(device: str, model_parallelism: int = 1):
    """HiCR path: each rank's `torchdev` topology, gathered into the world's
    Topology, then `mesh_from_topology` (sized by its devices: GPUs on
    ``cuda``, CPU ranks on ``cpu``). Returns (mesh, world topology)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import mesh_from_topology

    rank, world, dev = init_world(device)
    mine = torchdev.TorchTopologyManager(dev).query_topology()
    gathered = [None] * world
    dist.all_gather_object(gathered, mine)
    topo = Topology(devices=tuple(
        dataclasses.replace(d, device_id=f"rank{r}/{d.device_id}")
        for r, t in enumerate(gathered) for d in t.get_devices()))
    mesh = mesh_from_topology(topo, model_parallelism=model_parallelism, device_type=dev.type,
                              kind="gpu" if dev.type == "cuda" else "cpu")
    return mesh, topo


def _spmd_route(args) -> bool:
    return args.mesh is not None or "WORLD_SIZE" in os.environ


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

    mesh = None
    if _spmd_route(args):
        # ---- HiCR launcher: topology -> mesh -> SPMD compute manager -------
        model_par = 1
        if args.mesh:
            data, model_par = (int(x) for x in args.mesh.split("x"))
        mesh, _ = discover_mesh(args.device, model_par)
        if args.mesh and tuple(mesh.mesh.shape) != (data, model_par):
            raise ValueError(f"--mesh {args.mesh}: the world gives a mesh of "
                             f"{tuple(mesh.mesh.shape)}")
        cpm = spmd.SpmdComputeManager(mesh)
        pu = cpm.create_processing_unit(cpm.mesh_compute_resource())
        cpm.initialize(pu)
        device = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" \
            else torch.device("cpu")
    else:
        # ---- HiCR launcher: topology -> compute manager -> processing unit -
        topology = torchdev.TorchTopologyManager(args.device).query_topology()
        cpm = torchdev.TorchComputeManager(args.device)
        pu = cpm.create_processing_unit(topology.all_compute_resources()[0])
        cpm.initialize(pu)
        device = pu.context
    where = f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} of {device.type}" \
        if mesh is not None else str(device)
    print(f"training {cfg.name}{' (REDUCED)' if args.reduced else ''} on {where}: "
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
    if mesh is not None:
        params, opt_state, ef = shard_train_state(model, mesh, params, opt_state, ef)

    unit = cpm.create_execution_unit(make_train_step(model, ocfg, tcfg, mesh=mesh,
                                                     grads_hook=grads_hook),
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
            tree = {"params": params, "opt": opt_state}
            if mesh is not None:  # whole tensors, written by rank 0
                tree = tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t,
                                tree)
            if mesh is None or torch.distributed.get_rank() == 0:
                ckpt.save(args.ckpt_dir, step + 1, tree,
                          extra={"data": stream.state.to_dict(), "step": step + 1})
            if mesh is not None:
                torch.distributed.barrier()
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
