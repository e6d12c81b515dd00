"""The port's training example (`examples/train_100m_torch.py`) against the
JAX reference, on the CPU.

A narrow copy of the example's own config (2 layers, 2 query heads over 1
at head_dim 80 -- the example's head_dim, vocab 512; B=2 x S=32), with the
reference's `init_train_state(PRNGKey(0))` weights bridged into the port:

* 3 steps of the example's `train` (the SPMD compute manager over a gloo
  world of one, the prefetching loader) give the reference's jitted
  `make_train_step` losses, grad norms and learning rates within 1e-4
  relative on the same batches;
* 4 steps straight equal 2 steps, a checkpoint and a resume for 2 more,
  bit for bit;
* `sharding.ambient.constrain` leaves a plain tensor as it is under the
  example's active mesh;
* the ``--device cpu`` CLI runs 2 steps at the example's full widths in a
  subprocess, and without a card and without ``--device cpu`` it raises.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ShapeConfig as JShapeConfig  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.train import data as jdata  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.train.tree import tree_leaves  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
B, S = 2, 32


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


ex = _example("train_100m_torch")


def _narrow():
    """(port config, reference config): the example's config at 2 layers,
    2 query heads over 1 at its head_dim 80, vocab 512; a window of 16 and
    a global layer every 2, so both masks run."""
    cfg = ex.model_config().replace(num_layers=2, d_model=160, num_heads=2, num_kv_heads=1,
                                    d_ff=320, vocab_size=512, sliding_window=16,
                                    global_interval=2)
    assert cfg.head_dim == 80
    jcfg = jax_get_config("gemma3-1b", reduced=True)
    jcfg = jcfg.replace(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(jcfg)})
    return cfg, jcfg


@pytest.fixture(scope="module")
def narrow():
    cfg, jcfg = _narrow()
    jmodel = jax_build(jcfg)
    ocfg = ex.optimizer_config(3)
    jocfg = jopt.OptimizerConfig(**dataclasses.asdict(ocfg))
    jparams, _, jopt_state, _ = jts.init_train_state(jmodel, jocfg, jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, jcfg, jmodel, jocfg, jparams, jopt_state, host


def test_train_example_matches_reference_for_three_steps(narrow):
    cfg, jcfg, jmodel, jocfg, jparams, jopt_state, host = narrow
    params = params_from_jax(cfg, host, device="cpu")
    run = ex.train(cfg, params, torch.device("cpu"), steps=3, batch=B, seq=S,
                   out=lambda line: None)
    got = run.history

    jstep = jax.jit(jts.make_train_step(jmodel, jocfg, jts.TrainConfig()))
    stream = jdata.SyntheticTokenStream(jcfg, JShapeConfig("train100m", S, B, "train"))
    want = []
    p, o = jparams, jopt_state
    for _ in range(3):
        p, o, _, m = jstep(p, o, None, stream.next_batch())
        want.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    assert [h["step"] for h in got] == [1, 2, 3]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


def test_train_example_resume_is_bit_equal(narrow, tmp_path):
    cfg, _, _, _, _, _, host = narrow
    cpu = torch.device("cpu")
    quiet = dict(batch=B, seq=S, out=lambda line: None)
    straight = ex.train(cfg, params_from_jax(cfg, host, device="cpu"), cpu, steps=4, **quiet)
    ck = str(tmp_path / "ck")
    first = ex.train(cfg, params_from_jax(cfg, host, device="cpu"), cpu, steps=2, ckpt_dir=ck,
                     ckpt_every=2, **quiet)
    assert first.start_step == 0 and [h["step"] for h in first.history] == [1, 2]
    lines = []
    resumed = ex.train(cfg, params_from_jax(cfg, host, device="cpu"), cpu, steps=4,
                       ckpt_dir=ck, ckpt_every=2, batch=B, seq=S, out=lines.append)
    assert resumed.start_step == 2 and "resumed from checkpoint at step 2" in lines
    assert [h["step"] for h in resumed.history] == [3, 4]
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in straight.history[2:]]
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(straight.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(resumed.opt_state), tree_leaves(straight.opt_state)):
        assert torch.equal(a, b)


def test_constrain_is_a_no_op_on_plain_tensors_under_the_active_mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import init_world
    from repro_torch.sharding.ambient import active_mesh, constrain, get_active_mesh

    init_world("cpu")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        x = torch.randn(4, 6)
        with active_mesh(mesh):
            assert get_active_mesh() is mesh
            assert constrain(x, "data", "model") is x
            assert constrain(x, ("data", "model"), None) is x
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_train_example_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(os.path.join(ROOT, "src")))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "train_100m_torch.py"), "--device",
         "cpu", "--steps", "2", "--batch", "1", "--seq", "16", "--ckpt-dir",
         str(tmp_path / "ck"), "--ckpt-every", "100"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "model: 75.2M parameters (10L d=640 ff=2560 V=50304)" in out.stdout
    assert out.stdout.rstrip().endswith("done.")


def test_train_example_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ex.main(["--steps", "1"])
