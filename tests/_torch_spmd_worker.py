"""One rank of a `torch.distributed` gloo run on the CPU, for
`tests/test_torch_spmd.py` (imports torch and the port only, never JAX).

    python tests/_torch_spmd_worker.py TASK IN.pkl OUT_DIR RANK WORLD

The ranks meet through a ``file://`` rendezvous in OUT_DIR. Each task reads
its inputs from IN.pkl and writes ``rank{RANK}.pkl``.
"""
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist


def collectives(spec, rank, world):
    from repro_torch.backends.spmd import SpmdCommunicationManager
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((world,), ("x",))
    cm = SpmdCommunicationManager(mesh)
    x = torch.from_numpy(spec["x"][rank])
    return {
        "all_reduce": cm.all_reduce(x, "x").numpy(),
        "all_gather": cm.all_gather(x, "x", axis=1).numpy(),
        "reduce_scatter": cm.reduce_scatter(x, "x", scatter_dimension=1).numpy(),
        "all_to_all": cm.all_to_all(x, "x", split_axis=0, concat_axis=1).numpy(),
        "ppermute_halo": cm.ppermute_halo(x, "x", shift=1).numpy(),
    }


def train(specs, rank, world):
    """One mesh train step a spec (a list of them, one process group)."""
    return [_train_one(spec) for spec in specs]


def _train_one(spec):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build
    from repro_torch.models.bridge import params_from_jax
    from repro_torch.train import optimizer as topt
    from repro_torch.train import train_step as tts
    from repro_torch.train.tree import tree_map

    cfg = get_config(spec["arch"], reduced=True)
    if spec.get("replace"):
        cfg = cfg.replace(**spec["replace"])
    model = build(cfg)
    mesh = make_mesh(spec["mesh"], ("data", "model"))
    params = params_from_jax(cfg, spec["params"], device="cpu")
    ocfg = topt.OptimizerConfig(**spec["opt"])
    params, opt_state, _ = tts.shard_train_state(model, mesh, params, topt.init(ocfg, params))
    seen = []
    step = tts.make_train_step(model, ocfg, tts.TrainConfig(microbatches=spec["microbatches"]),
                               mesh=mesh, grads_hook=seen.append)
    p1, o1, _, m = step(params, opt_state, None, spec["batch"])
    full = lambda t: t.full_tensor().numpy() if hasattr(t, "full_tensor") else t.numpy()  # noqa: E731
    return {"params": tree_map(full, p1), "grads": tree_map(full, seen[0]),
            "mu": tree_map(full, o1["mu"]),
            "metrics": {k: float(v) for k, v in m.items()},
            "local_shapes": tree_map(lambda t: tuple(t.to_local().shape), p1)}


def main():
    task, in_path, out_dir, rank, world = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out_dir, 'rendezvous')}",
                            rank=rank, world_size=world)
    try:
        with open(in_path, "rb") as f:
            spec = pickle.load(f)
        out = {"collectives": collectives, "train": train}[task](spec, rank, world)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
