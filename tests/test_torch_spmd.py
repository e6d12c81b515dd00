"""The port's SPMD layer across CPU processes (gloo), against the JAX
reference.

* The five collectives of `backends/spmd.py`'s communication manager on 4
  ranks equal the reference's `SpmdCommunicationManager` collectives under
  `shard_map` on 4 host devices. The reference runs in one subprocess with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` set before it
  imports JAX (the flag stays out of this process); the port's ranks are
  processes of `tests/_torch_spmd_worker.py` meeting through a ``file://``
  rendezvous under ``tmp_path`` (no TCP port). Inputs come from numpy with
  a seed.
* One REDUCED fp32 train step with a `mesh` on 2 ranks equals the
  reference's single-device `make_train_step` on the same bridged weights
  and batch, held to `tests/test_torch_train.py`'s tolerances (loss and
  metrics rtol 1e-5, gradients rtol 1e-4 / atol 1e-6, updated parameters
  rtol 1e-4 / atol 1e-5): gemma3-1b on (2, 1) and (1, 2) ("data", "model")
  and with 2 microbatches, gemma3-1b with 6 query heads over 3 KV heads on
  (1, 2) (query heads sharded, KV heads replicated: each rank pairs its
  heads with their own KV heads), and grok-1 (MoE: the restored
  `constrain` pins and expert sharding) on (1, 2).

Every spawn has a timeout of its own.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORKER = os.path.join(HERE, "_torch_spmd_worker.py")
SPAWN_TIMEOUT = 240


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _run_ranks(task, spec, world, tmp_path):
    """Run `task` on `world` gloo ranks; their results, by rank."""
    in_path = tmp_path / "in.pkl"
    with open(in_path, "wb") as f:
        pickle.dump(spec, f)
    procs = [subprocess.Popen([sys.executable, WORKER, task, str(in_path), str(tmp_path),
                               str(r), str(world)], env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    out = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

_REFERENCE_COLLECTIVES = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.backends.spmd import SpmdCommunicationManager as C
    x = np.load(sys.argv[1])["x"]  # (ranks, ...) one block a rank
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    try:
        from jax import shard_map
        smap = lambda f: shard_map(f, mesh=mesh, in_specs=P("x"), out_specs=P("x"))
    except ImportError:
        from jax.experimental.shard_map import shard_map
        smap = lambda f: shard_map(f, mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                                   check_rep=False)
    flat = x.reshape((-1,) + x.shape[2:])
    ops = {
        "all_reduce": lambda b: C.all_reduce(b, "x"),
        "all_gather": lambda b: C.all_gather(b, "x", axis=1),
        "reduce_scatter": lambda b: C.reduce_scatter(b, "x", scatter_dimension=1),
        "all_to_all": lambda b: C.all_to_all(b, "x", split_axis=0, concat_axis=1),
        "ppermute_halo": lambda b: C.ppermute_halo(b, "x", shift=1),
    }
    out = {}
    for name, f in ops.items():
        y = np.asarray(jax.jit(smap(f))(flat))
        out[name] = y.reshape((4, -1) + y.shape[1:])
    np.savez(sys.argv[2], **out)
""")


def test_collectives_match_reference_shard_map(tmp_path):
    world = 4
    x = np.random.default_rng(5).standard_normal((world, 8, 12)).astype(np.float32)
    np.savez(tmp_path / "x.npz", x=x)
    ref = subprocess.run([sys.executable, "-c", _REFERENCE_COLLECTIVES, str(tmp_path / "x.npz"),
                          str(tmp_path / "ref.npz")], env=_env(JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    want = np.load(tmp_path / "ref.npz")
    got = _run_ranks("collectives", {"x": x}, world, tmp_path)
    for name in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all", "ppermute_halo"):
        for r in range(world):
            g, w = got[r][name], want[name][r]
            assert g.shape == w.shape, (name, r, g.shape, w.shape)
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=f"{name} rank {r}")


# ---------------------------------------------------------------------------
# one train step on a mesh
# ---------------------------------------------------------------------------

ADAMW = jopt.OptimizerConfig(name="adamw", learning_rate=1e-3)
SHAPE = JShapeConfig("t", seq_len=32, global_batch=4, kind="train")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(port, ref, *, rtol, atol, what):
    n = 0
    stack = [("", port, ref)]
    while stack:
        path, a, b = stack.pop()
        if isinstance(a, dict):
            assert set(a) == set(b), (what, path)
            stack += [(f"{path}/{k}", a[k], b[k]) for k in a]
        elif isinstance(a, list):
            assert len(a) == len(b), (what, path)
            stack += [(f"{path}/{i}", x, y) for i, (x, y) in enumerate(zip(a, b))]
        else:
            b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f"{what}{path}")
            n += 1
    assert n > 0


CASES = {
    "gemma3-2x1": ("gemma3-1b", (2, 1), 1, None),
    "gemma3-1x2": ("gemma3-1b", (1, 2), 1, None),
    "gemma3-2x1-micro2": ("gemma3-1b", (2, 1), 2, None),
    "gemma3-1x2-gqa6over3": ("gemma3-1b", (1, 2), 1, dict(num_heads=6, num_kv_heads=3)),
    "grok-1x2": ("grok-1-314b", (1, 2), 1, None),
}


@pytest.fixture(scope="module")
def mesh_steps(tmp_path_factory):
    """Every case's reference step, and the port's mesh steps of all the
    cases in one 2-rank gloo run (one spawn for the lot)."""
    import dataclasses

    specs, refs = [], {}
    for case, (arch, mesh, micro, replace) in CASES.items():
        jcfg = jax_get_config(arch, reduced=True)
        if replace:
            jcfg = jcfg.replace(**replace)
        jmodel = jax_build(jcfg)
        jparams, _, jopt_state, _ = jts.init_train_state(jmodel, ADAMW, jax.random.PRNGKey(0))
        batch = _np(jmodel.make_batch(jax.random.PRNGKey(2), SHAPE))
        jp1, jo1, _, jm = jax.jit(jts.make_train_step(jmodel, ADAMW, jts.TrainConfig(
            microbatches=micro)))(jparams, jopt_state, None, batch)
        jgrads = jax.jit(jax.grad(lambda p, b: jmodel.loss(p, b)[0]))(jparams, batch)
        refs[case] = (_np(jp1), _np(jo1["mu"]), {k: float(v) for k, v in jm.items()},
                      _np(jgrads))
        specs.append({"arch": arch, "replace": replace, "mesh": mesh, "microbatches": micro,
                      "params": _np(jparams), "batch": batch, "opt": dataclasses.asdict(ADAMW)})
    ranks = _run_ranks("train", specs, 2, tmp_path_factory.mktemp("mesh_steps"))
    return {case: ([r[i] for r in ranks], refs[case]) for i, case in enumerate(CASES)}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_train_step_matches_reference(case, mesh_steps):
    arch, mesh, micro, replace = CASES[case]
    cfg = get_config(arch, reduced=True)
    if replace:
        cfg = cfg.replace(**replace)
    ranks, (jp1, jmu, jm, jgrads) = mesh_steps[case]
    bridge = lambda t: params_from_jax(cfg, t, device="cpu")  # noqa: E731
    for r, got in enumerate(ranks):
        for key in ("loss", "ce_loss", "moe_aux", "grad_norm", "lr"):
            np.testing.assert_allclose(got["metrics"][key], jm[key], rtol=1e-5,
                                       err_msg=f"rank {r} {key}")
        _close(got["grads"], bridge(jgrads), rtol=1e-4, atol=1e-6, what=f"rank {r} grad ")
        _close(got["params"], bridge(jp1), rtol=1e-4, atol=1e-5, what=f"rank {r} param ")
        _close(got["mu"], bridge(jmu), rtol=1e-4, atol=1e-6, what=f"rank {r} mu ")
    # the parameters really are split where the plan splits them
    model_size = mesh[1]
    if model_size > 1:
        wq = ranks[0]["local_shapes"]["layers"][0]["attn"]["wq"]
        assert wq[1] == cfg.num_heads // model_size
