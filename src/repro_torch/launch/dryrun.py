"""Multi-device dry run: trace every (architecture × input shape) cell on a
target mesh without the hardware, proving the distribution plan coherent and
giving its roofline terms. Port of `repro/launch/dryrun.py`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k --mesh 2x4
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch grok-1-314b --shape decode_32k \\
        --mesh 2x4 --reduced --json /tmp/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

The process joins a ``fake`` process group of the mesh's size (rank 0 of
it; collectives complete at once and move nothing). Parameters, optimizer
state, batch and decode state are made on the ``meta`` device and placed by
the sharding plan as DTensors whose local shards are meta tensors, so
nothing is allocated; the cell's train step, prefill or decode step then
runs eagerly under `roofline.Counters`, which counts this rank's FLOPs,
bytes and collective bytes. Eager tracing counts every layer, so the
two-depth extrapolation of `calibrated_roofline` equals the full-depth
count. The reference's `compile_s` has no counterpart (nothing is compiled)
and is 0.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch

from repro_torch.configs import ARCH_IDS, LONG_CONTEXT_ARCHS, SHAPES, get_config, get_shape
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build
from repro_torch.models.model_zoo import logical_axes
from repro_torch.sharding import partition
from repro_torch.sharding.ambient import active_mesh
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_step import (
    TrainConfig,
    init_train_state,
    make_train_step,
    shard_train_state,
)
from repro_torch.train.tree import tree_leaves


def fake_world(size: int) -> None:
    """Join (or re-join at another size) a ``fake`` process group of
    `size` ranks as rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def dry_mesh(shape, axes=None):
    """A CPU `DeviceMesh` of `shape` over a fake world of its size; axes
    default to the trailing names of ("pod", "data", "model")."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    fake_world(n)
    return make_mesh(shape, axes or ("pod", "data", "model")[-len(shape):], device_type="cpu")


def param_counts(params, axes_tree):
    """(total, expert) parameter counts of a tree and its logical axes."""
    total, expert = 0, 0
    for leaf, axes in zip(tree_leaves(params), tree_leaves(axes_tree)):
        n = leaf.numel()
        total += n
        if "expert" in axes:
            expert += n
    return total, expert


def calib_plan(cfg):
    """Depth-calibration plan: (layers_for_ka, layers_for_kb, ka_units,
    kb_units, full_units, tail_units), as the reference's: roofline totals
    from two reduced-depth traces, extrapolated linearly in depth (the
    sliding-window unit / hybrid group is the extrapolation unit)."""
    if cfg.family == "ssm":
        return None  # python-loop blocks: the trace is exact already
    if cfg.family == "hybrid":
        g = cfg.shared_attn_interval
        full = cfg.num_layers // g
        tail = (cfg.num_layers % g) / g
        return (g, 2 * g, 1, 2, full, tail)
    if cfg.sliding_window and cfg.global_interval:
        g = cfg.global_interval
        full = cfg.num_layers // g
        tail = (cfg.num_layers % g) / g
        return (g, 2 * g, 1, 2, full, tail)
    return (1, 2, 1, 2, cfg.num_layers, 0.0)


def calibrated_roofline(arch, shape_id, mesh, *, opt_name=None, microbatches=1, remat=None,
                        cfg_overrides=None, reduced=False):
    """Depth-extrapolated roofline terms from two reduced-depth traces on
    the SAME mesh (collectives included)."""
    cfg = get_config(arch, reduced=reduced)
    plan = calib_plan(cfg)
    base_over = dict(cfg_overrides or {})
    kw = dict(opt_name=opt_name, microbatches=microbatches, remat=remat, verbose=False,
              reduced=reduced)

    def trace_depth(layers):
        over = dict(base_over, num_layers=layers, scan_layers=False)
        if cfg.family == "audio":
            over["encoder_layers"] = layers
        return lower_cell(arch, shape_id, mesh, cfg_overrides=over, **kw)[1]

    if plan is None:  # exact already
        info = lower_cell(arch, shape_id, mesh, cfg_overrides=dict(base_over, scan_layers=False),
                          **kw)[1]
        r = info["roofline"]
        return {
            "flops_per_device": r["flops_per_device"],
            "bytes_per_device": r["bytes_per_device"],
            "collective_bytes_per_device": r["collective_bytes_per_device"],
            "method": "exact-unrolled",
        }

    la, lb, ka, kb, full_units, tail_units = plan
    ia = trace_depth(la)
    ib = trace_depth(lb)

    def extrap(key):
        a = ia["roofline"][key]
        b = ib["roofline"][key]
        per_unit = (b - a) / (kb - ka)
        return a + (full_units - ka + tail_units) * per_unit

    return {
        "flops_per_device": extrap("flops_per_device"),
        "bytes_per_device": extrap("bytes_per_device"),
        "collective_bytes_per_device": extrap("collective_bytes_per_device"),
        "method": f"unroll-calibrated({la},{lb})",
        "calib_points": [ia["roofline"], ib["roofline"]],
    }


class LiveBytes(rl.Counters):
    """`Counters` that also keep the peak of this rank's live bytes: every
    storage an op makes is counted until it is freed (the local shards of
    the arguments are counted as `argument_bytes`, given at the start)."""

    def __init__(self, argument_bytes: int = 0):
        super().__init__()
        self.live = self.peak = argument_bytes
        self._seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or any(t is not torch.Tensor for t in types):
            return out
        for x in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(x, torch.Tensor):
                self._track(x)
        return out

    def _track(self, x: torch.Tensor) -> None:
        st = x.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n


def _local_bytes(tree) -> int:
    from torch.utils._pytree import tree_flatten

    total = 0
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            local = x.to_local() if hasattr(x, "to_local") else x
            total += local.numel() * local.element_size()
    return total


def _mesh_dict(mesh) -> dict:
    return dict(partition.mesh_shape(mesh))


def lower_cell(arch: str, shape_id: str, mesh, *, opt_name=None, microbatches=1, remat=None,
               verbose=True, cfg_overrides=None, grad_compression=None, reduced=False):
    """Trace one cell on `mesh` (a `dry_mesh`). Returns (None, info): the
    reference returns its compiled executable first; here nothing is
    compiled."""
    shape = get_shape(shape_id)
    cfg = get_config(arch, reduced=reduced)
    if remat:
        cfg = cfg.replace(remat_policy=remat)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    model = build(cfg)
    plan = partition.default_plan(cfg)

    t0 = time.time()
    params = model.init(seed=0, device="meta")
    axes_tree = logical_axes(cfg, params)
    n_total, n_expert = param_counts(params, axes_tree)
    n_active = None
    if cfg.is_moe:
        n_active = n_total - n_expert + n_expert * cfg.experts_per_token // cfg.num_experts
    batch = model.input_specs(shape)

    if shape.kind == "train":
        if opt_name is None:
            opt_name = "adafactor" if n_total * 2 > 50e9 else "adamw"
        ocfg = opt_lib.OptimizerConfig(name=opt_name)
        tc = TrainConfig(microbatches=microbatches, grad_compression=grad_compression)
        _, opt_state, ef = init_train_state(model, ocfg, train_cfg=tc, params=params)
        args = shard_train_state(model, mesh, params, opt_state, ef)
        step = make_train_step(model, ocfg, tc, mesh=mesh)
        arg_bytes = _local_bytes(args) + _local_bytes(
            partition.distribute(batch, partition.input_shardings(batch, mesh, cfg, shape), mesh))
        run = lambda: step(*args, batch)  # noqa: E731  (the step places the batch)
    else:
        from torch.distributed.tensor.experimental import implicit_replication

        p_in = partition.distribute(params, partition.param_shardings(axes_tree, params, mesh,
                                                                      plan), mesh)
        b_in = partition.distribute(batch, partition.input_shardings(batch, mesh, cfg, shape),
                                    mesh)
        if shape.kind == "prefill":
            prefill = model.make_prefill(shape.seq_len)
            fn, call_args = prefill, (p_in, b_in)
        else:
            state = model.state_specs(shape)
            s_in = partition.distribute(state, partition.state_shardings(state, mesh, cfg, shape),
                                        mesh)
            fn, call_args = model.decode_step, (p_in, s_in, b_in)
        arg_bytes = _local_bytes(call_args)

        def run():
            with torch.no_grad(), active_mesh(mesh), implicit_replication():
                return fn(*call_args)

    counts = LiveBytes(arg_bytes)
    with counts:
        run()
    t_lower = time.time() - t0

    chips = mesh.size()
    roof = rl.analyze(counts, chips=chips)
    mf = rl.model_flops(cfg, shape, n_params=n_total, n_active_params=n_active)
    mem = {"argument_size_in_bytes": int(arg_bytes), "peak_live_bytes": int(counts.peak)}
    info = {
        "arch": arch,
        "shape": shape_id,
        "mesh": _mesh_dict(mesh),
        "chips": chips,
        "n_params": n_total,
        "n_active_params": n_active,
        "optimizer": opt_name if shape.kind == "train" else None,
        "lower_s": round(t_lower, 2),
        "compile_s": 0.0,
        "memory": mem,
        "roofline": roof.to_dict(),
        "model_flops_global": mf,
        "collectives": counts.collectives(),
    }
    if verbose:
        print(
            f"[{arch} × {shape_id} × {chips}chips] OK trace={t_lower:.1f}s "
            f"args/dev={mem['argument_size_in_bytes'] / 2**30:.2f}GiB "
            f"peak/dev={mem['peak_live_bytes'] / 2**30:.2f}GiB "
            f"flops/dev={roof.flops_per_device:.3e} "
            f"dominant={roof.dominant} bound={roof.bound_s * 1e3:.2f}ms", flush=True
        )
    return None, info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 4x2 or 2x2x2 (pod,data,model)")
    ap.add_argument("--json", default=None, help="directory for per-cell json records")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--calibrate", action="store_true",
                    help="add depth-calibrated roofline totals (2 extra traces/cell)")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the optimization stack (blocked attention, sequential SSD, "
                         "remat=full + 4 sharded microbatches on train shapes) instead of the "
                         "paper-faithful baseline")
    ap.add_argument("--reduced", action="store_true", help="the REDUCED configs")
    args = ap.parse_args(argv)

    def build_mesh(multi_pod: bool):
        if args.mesh:
            return dry_mesh(tuple(int(x) for x in args.mesh.split("x")))
        from repro_torch.launch.mesh import PRODUCTION_SHAPES

        shape, axes = PRODUCTION_SHAPES[multi_pod]
        return dry_mesh(shape, axes)

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            for shape_id in SHAPES:
                if shape_id == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                    continue
                cells.append((arch, shape_id))
    else:
        cells.append((args.arch, args.shape))

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    failures = []
    for multi_pod in meshes:
        mesh = build_mesh(multi_pod)
        print(f"=== mesh {_mesh_dict(mesh)} ({mesh.size()} chips) ===", flush=True)
        for arch, shape_id in cells:
            microbatches, remat, overrides = args.microbatches, args.remat, None
            if args.optimized:
                overrides = {"attention_impl": "blocked", "ssd_impl": "sequential"}
                if get_shape(shape_id).kind == "train":
                    remat = remat or "full"
                    microbatches = max(microbatches, 4)
            try:
                _, info = lower_cell(arch, shape_id, mesh, opt_name=args.optimizer,
                                     microbatches=microbatches, remat=remat,
                                     cfg_overrides=overrides, reduced=args.reduced)
                if args.calibrate:
                    cal = calibrated_roofline(arch, shape_id, mesh, opt_name=args.optimizer,
                                              microbatches=microbatches, remat=remat,
                                              cfg_overrides=overrides, reduced=args.reduced)
                    roof = rl.Roofline(
                        flops_per_device=cal["flops_per_device"],
                        bytes_per_device=cal["bytes_per_device"],
                        collective_bytes_per_device=cal["collective_bytes_per_device"],
                        chips=mesh.size(),
                    )
                    info["roofline_calibrated"] = dict(cal, **roof.to_dict())
                    print(f"    calibrated: compute={roof.compute_s * 1e3:.2f}ms "
                          f"memory={roof.memory_s * 1e3:.2f}ms "
                          f"collective={roof.collective_s * 1e3:.2f}ms "
                          f"dominant={roof.dominant}", flush=True)
                if args.json:
                    os.makedirs(args.json, exist_ok=True)
                    tag = f"{arch}__{shape_id}__{'x'.join(map(str, mesh.mesh.shape))}"
                    with open(os.path.join(args.json, tag + ".json"), "w") as f:
                        json.dump(info, f, indent=1)
            except Exception:  # noqa: BLE001
                failures.append((arch, shape_id, _mesh_dict(mesh)))
                print(f"[{arch} × {shape_id}] FAILED", flush=True)
                traceback.print_exc()
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run: all cells passed")


if __name__ == "__main__":
    main()
