"""The port's sharding plan, roofline and dry run against the JAX
reference, on the CPU: the torch counterpart of `tests/test_sharding.py`
and `tests/test_roofline.py`.

* For every arch of `ARCH_IDS` at full width, the port's logical axes
  (`model_zoo.logical_axes`, on parameters made on the ``meta`` device)
  equal the reference's (from `jax.eval_shape` of `model.init`) with the
  stack axes ("layers", "units") dropped, and `spec_for_leaf` gives the
  reference's spec, stack dims dropped, for every leaf on the duck meshes
  (16, 16) and (2, 16, 16).
* `batch_spec`, `state_shardings` and `opt_state_shardings` (AdamW's
  moments, and Adafactor's factored statistics in the stacked layout) equal
  the reference's on its tests' cases.
* `Roofline` and `model_flops` equal the reference's given the same
  `ChipSpec` numbers (the H100 datasheet's).
* A fake-process-group dry run of REDUCED gemma3-1b `train_4k` and REDUCED
  grok-1 `decode_32k` on a 2 × 4 mesh completes in a subprocess (the fake
  world stays out of this one); its parameter counts equal the reference's
  `param_counts`, and `calibrated_roofline` equals the full-depth count.
* `mesh_from_topology` raises as the reference's does.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.backends.tpu_spec import ChipSpec as JChipSpec  # noqa: E402
from repro.configs import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.sharding import partition as jpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.backends.gpu_spec import H100, SpecTopologyManager  # noqa: E402
from repro_torch.configs import ARCH_IDS, ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.mesh import mesh_from_topology, mesh_shape_from_topology  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.bridge import stack_params  # noqa: E402
from repro_torch.models.model_zoo import logical_axes  # noqa: E402
from repro_torch.sharding import partition as pt  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
STACK_AXES = ("layers", "units")
STACKS = {"units": "layers", "tail": "layers", "mamba_tail": "mamba"}


class FakeMesh:
    """Duck-typed mesh (the reference tests' own): only `shape` is read."""

    def __init__(self, **shape):
        self.shape = shape


class _NS:
    """Stands in for `NamedSharding` on the reference side so its spec logic
    runs on a duck mesh (as `tests/test_sharding.py` does)."""

    def __init__(self, mesh, spec):
        self.spec = spec


@pytest.fixture
def ref_named_sharding(monkeypatch):
    monkeypatch.setattr(jpt, "NamedSharding", _NS)


def _ref_tree(arch, reduced=False):
    model = jax_build(jax_get_config(arch, reduced=reduced))
    box = {}

    def init_only():
        p, axes = model.init(jax.random.PRNGKey(0))
        box["axes"] = axes
        return p

    return jax.eval_shape(init_only), box["axes"]


def _flat(tree, path=()):
    """(normalised path, leaf) pairs: list indices and the stacks' names
    dropped, so every layer of a stack shares one path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (STACKS.get(k, k),))
    elif isinstance(tree, list):
        for v in tree:
            yield from _flat(v, path)
    else:
        yield "/".join(path), tree


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def _ref_leaves(arch):
    """{path: {(axes without stack axes, shape without stack dims)}} of the
    reference's full-width tree."""
    specs, axes = _ref_tree(arch)
    shapes = dict(_flat(jax.tree_util.tree_map(lambda s: tuple(s.shape), specs,
                                               is_leaf=lambda x: hasattr(x, "shape"))))
    out = {}
    flat_axes = list(_flat(jax.tree_util.tree_map(lambda a: a, axes, is_leaf=_is_axes)))
    flat_shapes = [tuple(s.shape) for s in jax.tree_util.tree_leaves(specs)]
    # the axes tree's leaves walk in the same (sorted-key) order as the specs'
    jax_paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(specs)[0]]
    for jp, shape in zip(jax_paths, flat_shapes):
        keys = [STACKS.get(k.key, k.key) for k in jp if hasattr(k, "key")]
        a = axes
        for k in jp:
            a = a[k.key] if hasattr(k, "key") else a[k.idx]
        n_stack = sum(1 for x in a if x in STACK_AXES)
        out.setdefault("/".join(keys), set()).add((a[n_stack:], shape[n_stack:]))
    assert flat_axes and shapes
    return out


def _port_leaves(arch):
    cfg = get_config(arch)
    params = build(cfg).init(seed=0, device="meta")
    axes = dict(_flat(logical_axes(cfg, params)))
    out = {}
    for (path, leaf), (_, ax) in zip(_flat(params), _flat(logical_axes(cfg, params))):
        out.setdefault(path, set()).add((ax, tuple(leaf.shape)))
    assert axes
    return cfg, params, out


@pytest.fixture(scope="module", params=ARCH_IDS)
def full_width(request):
    arch = request.param
    cfg, params, port = _port_leaves(arch)
    return arch, cfg, params, port, _ref_leaves(arch)


def test_logical_axes_match_reference(full_width):
    arch, cfg, params, port, ref = full_width
    assert assert_same_keys(port, ref, arch)
    for path in ref:
        assert port[path] == ref[path], (arch, path, port[path], ref[path])
    for leaf in jax.tree_util.tree_leaves(params):
        assert leaf.device.type == "meta"  # nothing was drawn


def assert_same_keys(port, ref, arch):
    assert set(port) == set(ref), (arch, sorted(set(port) ^ set(ref)))
    return True


@pytest.mark.parametrize("mesh_shape", [dict(data=16, model=16),
                                        dict(pod=2, data=16, model=16)], ids=["16x16", "2x16x16"])
def test_spec_for_leaf_matches_reference(full_width, mesh_shape):
    arch, cfg, params, port, ref = full_width
    mesh = FakeMesh(**mesh_shape)
    jcfg = jax_get_config(arch)
    jplan, plan = jpt.default_plan(jcfg), pt.default_plan(cfg)
    assert plan == pt.Plan(rules=jplan.rules, fsdp=jplan.fsdp)
    n = 0
    for path, leaves in ref.items():
        want = {tuple(jpt.spec_for_leaf(a, s, mesh, jplan)) for a, s in leaves}
        got = {tuple(pt.spec_for_leaf(a, s, mesh, plan)) for a, s in port[path]}
        assert got == want, (arch, path, got, want)
        n += 1
    assert n


def test_stacked_reference_specs_drop_only_stack_dims(ref_named_sharding):
    """On the reference's own stacked tree its specs carry None for every
    stack dim: the port's per-layer specs lose nothing."""
    specs, axes = _ref_tree("gemma3-1b")
    mesh = FakeMesh(data=16, model=16)
    shard = jpt.param_shardings(axes, specs, mesh, jpt.default_plan(jax_get_config("gemma3-1b")))
    for a, sh in zip(jax.tree_util.tree_leaves(axes, is_leaf=_is_axes),
                     jax.tree_util.tree_leaves(shard, is_leaf=lambda x: isinstance(x, _NS))):
        for ax, part in zip(a, sh.spec):
            if ax in STACK_AXES:
                assert part is None


# ---------------------------------------------------------------------------
# batch, state and optimizer-state specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pod", [1, 2])
@pytest.mark.parametrize("data", [1, 4, 16])
def test_batch_spec_matches_reference(pod, data):
    mesh = FakeMesh(pod=pod, data=data, model=16)
    for batch in (1, 2, 4, 8, 16, 32, 128, 256):
        assert tuple(pt.batch_spec(mesh, batch)) == tuple(jpt.batch_spec(mesh, batch)), batch
    mesh = FakeMesh(pod=2, data=16, model=16)
    assert pt.batch_spec(mesh, 16) == pt.P("data")
    assert pt.batch_spec(mesh, 1) == pt.P(None)


def test_input_shardings_match_reference():
    mesh = FakeMesh(data=2, model=4)
    for arch in ("gemma3-1b", "paligemma-3b", "whisper-small"):
        jmodel, model = jax_build(jax_get_config(arch)), build(get_config(arch))
        for kind in ("train", "prefill", "decode"):
            jshape, shape = JShapeConfig("s", 320, 8, kind), ShapeConfig("s", 320, 8, kind)
            jspecs, specs = jmodel.input_specs(jshape), model.input_specs(shape)
            assert set(specs) == set(jspecs)
            for k, v in specs.items():
                assert tuple(v.shape) == jspecs[k].shape and v.device.type == "meta", (arch, k)
                assert str(v.dtype).split(".")[-1] == str(jspecs[k].dtype), (arch, k)
            got = pt.input_shardings(specs, mesh, get_config(arch), shape)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jpt, "NamedSharding", _NS)
                want = jpt.input_shardings(jspecs, mesh, jax_get_config(arch), jshape)
            assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v.spec)
                                                            for k, v in want.items()}


@pytest.mark.parametrize("arch,shape,mesh,kv_shape", [
    ("minitron-8b", ("decode_32k", 32768, 128, "decode"), dict(data=16, model=8),
     (128, 32768, 8, 128)),
    ("zamba2-7b", ("long_500k", 524288, 1, "decode"), dict(data=16, model=16),
     (1, 524288, 32, 112)),
    ("grok-1-314b", ("decode_32k", 32768, 128, "decode"), dict(data=16, model=16),
     (128, 32768, 8, 128)),
], ids=["kv-heads-on-model", "sequence-parallel", "sequence-over-model"])
def test_state_shardings_match_reference(arch, shape, mesh, kv_shape, ref_named_sharding):
    mesh = FakeMesh(**mesh)
    want = jpt.state_shardings({"kv": jax.ShapeDtypeStruct(kv_shape, jax.numpy.bfloat16)}, mesh,
                               jax_get_config(arch), JShapeConfig(*shape))
    got = pt.state_shardings({"kv": (torch.empty(kv_shape, device="meta"),)}, mesh,
                             get_config(arch), ShapeConfig(*shape))
    assert tuple(got["kv"][0]) == tuple(want["kv"].spec)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_opt_state_shardings_match_reference(name, ref_named_sharding):
    """REDUCED gemma3-1b on a (2, 4) duck mesh: every optimizer leaf's spec,
    AdamW's per-layer moments and Adafactor's factored statistics (in the
    reference's stacked layout) alike."""
    arch = "gemma3-1b"
    mesh = FakeMesh(data=2, model=4)
    jspecs, jaxes = _ref_tree(arch, reduced=True)
    jcfg, cfg = jax_get_config(arch, reduced=True), get_config(arch, reduced=True)
    jp_sh = jpt.param_shardings(jaxes, jspecs, mesh, jpt.default_plan(jcfg))
    jocfg = jopt.OptimizerConfig(name=name)
    jo_specs = jax.eval_shape(lambda p: jopt.init(jocfg, p), jspecs)
    want = jpt.opt_state_shardings(jo_specs, jspecs, jp_sh, mesh)

    model = build(cfg)
    params = model.init(seed=0, device="meta")
    ocfg = topt.OptimizerConfig(name=name)
    if name == "adafactor":
        ref_tree, axes = stack_params(cfg, params), tts.stacked_axes(cfg, params)
    else:
        ref_tree, axes = params, logical_axes(cfg, params)
    p_specs = pt.param_shardings(axes, ref_tree, mesh, pt.default_plan(cfg))
    got = pt.opt_state_shardings(topt.init(ocfg, ref_tree), ref_tree, p_specs, mesh)

    if name == "adafactor":  # the same stacked tree: leaf for leaf
        flat_want = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
                     jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, _NS))[0]}
        flat_got = {}

        def walk(node, path=""):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{path}[{k!r}]")
            else:
                flat_got[path] = tuple(node)

        walk(got)
        assert flat_got == flat_want
    else:  # per-layer moments: the reference's specs with the stack dims dropped
        want_by_path, got_by_path = {}, {}
        for jp, s in jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, _NS))[0]:
            keys = [STACKS.get(k.key, k.key) for k in jp if hasattr(k, "key")]
            parts = tuple(s.spec)
            n_stack = 2 if "units" in [k.key for k in jp if hasattr(k, "key")] else (
                1 if keys[1:2] == ["layers"] else 0)
            want_by_path.setdefault("/".join(keys), set()).add(parts[n_stack:])
        for path, spec in _flat(got):
            got_by_path.setdefault(path, set()).add(tuple(spec))
        assert got_by_path == want_by_path


def test_shard_train_state_places_every_leaf():
    """`shard_train_state` on a one-rank fake world: parameters, AdamW's
    moments and Adafactor's stacked statistics all become DTensors with the
    plan's placements; the step count is replicated."""
    code = f"""
import sys; sys.path.insert(0, {SRC!r})
import torch
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import dry_mesh
from repro_torch.models import build
from repro_torch.train import optimizer as topt, train_step as tts
from repro_torch.train.tree import tree_leaves
mesh = dry_mesh((2, 4))
cfg = get_config("gemma3-1b", reduced=True)
model = build(cfg)
for name, comp in (("adamw", None), ("adafactor", "int8_ef")):
    ocfg = topt.OptimizerConfig(name=name)
    tc = tts.TrainConfig(grad_compression=comp)
    params, opt, ef = tts.init_train_state(model, ocfg, device="meta", train_cfg=tc)
    p, o, e = tts.shard_train_state(model, mesh, params, opt, ef)
    leaves = tree_leaves(p) + tree_leaves(o) + (tree_leaves(e) if e is not None else [])
    assert all(hasattr(x, "placements") for x in leaves), name
    wq = p["layers"][0]["attn"]["wq"]
    assert wq.to_local().shape == (64, 1, 16), wq.to_local().shape
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

JH100 = JChipSpec(**dataclasses.asdict(H100))


@pytest.mark.parametrize("terms", [(989e12, 3.35e12, 50e9), (1e12, 3.35e12 * 5, 0.0),
                                   (1.5e15, 7e11, 9e11)])
def test_roofline_matches_reference(terms):
    want = jrl.Roofline(*terms, chips=256, chip=JH100)
    got = rl.Roofline(*terms, chips=256, chip=H100)
    assert got.to_dict() == pytest.approx(want.to_dict()) or got.to_dict() == want.to_dict()
    assert got.dominant == want.dominant and got.bound_s == pytest.approx(want.bound_s)


def test_h100_spec_is_the_datasheet():
    assert H100.peak_flops_bf16 == 989e12 and H100.hbm_bandwidth == 3.35e12
    assert H100.hbm_bytes == 80 * 10**9 and H100.ici_links_per_chip == 18
    r = rl.Roofline(989e12, 3.35e12, 50e9, chips=8)
    assert (r.compute_s, r.memory_s, r.collective_s) == pytest.approx((1.0, 1.0, 1.0))


@pytest.mark.parametrize("arch", ["gemma3-1b", "grok-1-314b"])
@pytest.mark.parametrize("shape", [("t", 4096, 256, "train"), ("d", 32768, 128, "decode"),
                                   ("p", 128, 8, "prefill")])
def test_model_flops_matches_reference(arch, shape):
    for n, active in ((10**9, None), (100, 30)):
        want = jrl.model_flops(jax_get_config(arch), JShapeConfig(*shape), n_params=n,
                               n_active_params=active)
        got = rl.model_flops(get_config(arch), ShapeConfig(*shape), n_params=n,
                             n_active_params=active)
        assert got == want


def test_collective_bytes_keeps_the_reference_keys():
    out = rl.collective_bytes([("all_reduce", 64), ("all_gather_into_tensor", 128),
                               ("reduce_scatter_tensor", 32), ("all_to_all_single", 16),
                               ("mm", 999)])
    assert set(out) == set(jrl.collective_bytes("ENTRY %m (x: f32[4]) -> f32[4] {\n}"))
    assert out["all-reduce"] == 64 and out["all-gather"] == 128
    assert out["reduce-scatter"] == 32 and out["all-to-all"] == 16 and out["total"] == 240


# ---------------------------------------------------------------------------
# the dry run on a fake process group
# ---------------------------------------------------------------------------


_REFERENCE_COUNTS = """
import json, sys
import jax
from repro.configs import get_config
from repro.launch.dryrun import param_counts  # sets XLA_FLAGS: only in this process
from repro.models import build
is_axes = lambda x: isinstance(x, tuple) and all(isinstance(a, str) for a in x)
out = {}
for arch in sys.argv[1:]:
    model, box = build(get_config(arch, reduced=True)), {}
    def init_only():
        p, axes = model.init(jax.random.PRNGKey(0))
        box["axes"] = axes
        return p
    specs = jax.eval_shape(init_only)
    whole = jax.tree_util.tree_map(lambda a: "|".join(a), box["axes"], is_leaf=is_axes)
    out[arch] = [param_counts(specs, box["axes"]), param_counts(specs, whole)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_counts():
    """The reference's `param_counts` of the dry-run cells' REDUCED configs,
    as it is and with each axes tuple whole, from a subprocess: importing
    `repro.launch.dryrun` sets a 512-device `XLA_FLAGS`, which must stay out
    of this process."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE_COUNTS, "gemma3-1b", "grok-1-314b"],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape_id", [("gemma3-1b", "train_4k"),
                                           ("grok-1-314b", "decode_32k")])
def test_fake_group_dry_run_matches_reference_counts(arch, shape_id, tmp_path,
                                                     reference_counts):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", shape_id, "--mesh", "2x4", "--reduced", "--calibrate",
                        "--json", str(tmp_path)], capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rec = json.loads((tmp_path / f"{arch}__{shape_id}__2x4.json").read_text())
    assert rec["mesh"] == {"data": 2, "model": 4} and rec["chips"] == 8
    jcfg = jax_get_config(arch, reduced=True)
    (total, expert), (total_whole, expert_whole) = reference_counts[arch]
    assert rec["n_params"] == total == total_whole
    if jcfg.is_moe:
        # a reference fault: `jax.tree_util` flattens each axes tuple into
        # its names, so the reference's `param_counts` pairs leaves with
        # names and counts no expert parameter (its n_active_params is
        # n_params). Its count as meant, each tuple whole:
        assert expert == 0
        expert = expert_whole
        assert expert > 0
        active = total - expert + expert * jcfg.experts_per_token // jcfg.num_experts
        assert rec["n_active_params"] == active < total
    else:
        assert rec["n_active_params"] is None
    roof, cal = rec["roofline"], rec["roofline_calibrated"]
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["peak_live_bytes"] >= rec["memory"]["argument_size_in_bytes"]
    # eager tracing counts every layer: the depth extrapolation is exact
    for key in ("flops_per_device", "bytes_per_device", "collective_bytes_per_device"):
        assert cal[key] == pytest.approx(roof[key], rel=1e-9), key
    if arch == "gemma3-1b":  # DP gradient reduction and TP collectives exist
        assert rec["collectives"]["total"] > 0


def test_mesh_from_topology_uses_hicr_topology():
    """The launcher path: the mesh builder consumes a HiCR Topology (the
    declarative spec-sheet one), sizing first, as the reference's test."""
    topo = SpecTopologyManager(nodes=1, gpus_per_node=4).query_topology()
    assert mesh_shape_from_topology(topo, model_parallelism=2) == ((2, 2), ("data", "model"))
    with pytest.raises(Exception):
        # 4 GPUs but no process group of 4 ranks to back them
        mesh_from_topology(topo, model_parallelism=2)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_from_topology(topo, model_parallelism=3)
    two = SpecTopologyManager(nodes=2).query_topology()
    assert mesh_shape_from_topology(two) == ((2, 1, 8), ("pod", "data", "model"))
    from repro_torch.backends.torchdev import TorchTopologyManager

    with pytest.raises(ValueError, match="no GPU"):
        mesh_from_topology(TorchTopologyManager("cpu").query_topology())


class _DuckDeviceMesh:
    """What `placements` reads of a `DeviceMesh`: its named dims and sizes."""

    def __init__(self, **shape):
        self.mesh_dim_names = tuple(shape)
        self._sizes = tuple(shape.values())
        self.ndim = len(shape)

    def size(self, i):
        return self._sizes[i]


def test_placements_of_a_spec():
    """A dim over two mesh axes is `Shard(d)` on both; a mesh axis of size 1
    is `Replicate` (it holds the whole tensor either way)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _DuckDeviceMesh(pod=2, data=2, model=2)
    assert pt.placements(pt.P(("pod", "data"), None, "model"), mesh) == (Shard(0), Shard(0),
                                                                           Shard(2))
    assert pt.placements(pt.P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert pt.placements(pt.P(), mesh) == (Replicate(),) * 3
    assert pt.placements(pt.P("data", "model"), _DuckDeviceMesh(data=1, model=4)) == (
        Replicate(), Shard(1))


def test_constrain_is_a_no_op_without_a_mesh_or_a_dtensor():
    """The reference's `TestAmbientConstrain`: nothing happens without an
    ambient mesh, nor to a plain tensor under one."""
    from repro_torch.sharding.ambient import active_mesh, constrain, get_active_mesh

    x = torch.ones((4, 4))
    assert constrain(x, "data") is x
    mesh = _DuckDeviceMesh(data=1, model=1)
    with active_mesh(mesh):
        assert get_active_mesh() is mesh
        assert constrain(x, ("pod", "data"), "model") is x
    assert get_active_mesh() is None
