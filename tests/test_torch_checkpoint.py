"""The port's checkpoint route against the JAX reference.

The reference's `train/checkpoint.py::save` writes an `init_lm` tree
(fp32, and a copy cast to bf16) into a temporary directory; the port's
reader (`repro_torch/train/checkpoint.py`) gives back every leaf bit for
bit, with neither JAX nor `ml_dtypes` imported, and the weight bridge turns
the read tree into the same parameters as the in-process tree. The serving
CLI's ``--ckpt-dir`` then serves token-identically to the in-process bridge
and to the reference's scheduler on the restored weights.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.serve.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serve.workload import synthetic_requests as jax_synthetic_requests  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.runtime import Runtime  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatchingScheduler  # noqa: E402
from repro_torch.serve.workload import synthetic_requests  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("gemma3-1b", "xlstm-125m", "zamba2-7b")


def _reference_params(arch, dtype):
    jcfg = jax_get_config(arch, reduced=True)
    params, _ = jax_build(jcfg).init(jax.random.PRNGKey(0))
    if dtype == "bfloat16":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), params)
    return jax.tree_util.tree_map(np.asarray, params)


def _bits(a):
    """A leaf's raw bits: bf16 as int16, everything else as is."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.kind == "V" or a.dtype.name == "bfloat16" else a


def _pairs(got, want, path=""):
    """(path, port leaf, reference leaf) over two trees of one structure."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            yield from _pairs(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            yield from _pairs(g, w, f"{path}/{i}")
    else:
        yield path, got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reader_gives_back_every_leaf_bit_for_bit(tmp_path, arch, dtype):
    params = _reference_params(arch, dtype)
    jckpt.save(str(tmp_path), 7, {"params": params}, extra={"seed": 3})
    got, extra = tckpt.restore(str(tmp_path))
    assert extra == {"seed": 3} and set(got) == {"params"}
    n = 0
    for path, g, w in _pairs(got["params"], params):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu", path
        assert g.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32), path
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=path)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(params))
    # the bridge gives the in-process tree's parameters, bit for bit
    cfg = get_config(arch, reduced=True)
    for path, a, b in _pairs(params_from_jax(cfg, got["params"], device="cpu"),
                             params_from_jax(cfg, params, device="cpu")):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_reference_restore_cannot_cast_bf16_leaves(tmp_path):
    """The reference reads a bf16 leaf back as 2-byte void and its
    `restore` fails casting it to the template's dtype; the port's reader
    takes the manifest's dtype and views the bits as bf16."""
    params = _reference_params("gemma3-1b", "bfloat16")
    jckpt.save(str(tmp_path), 1, {"params": params})
    template, _ = jax_build(jax_get_config("gemma3-1b", reduced=True)).init(
        jax.random.PRNGKey(0))
    with pytest.raises(ValueError):
        jckpt.restore(str(tmp_path), {"params": template})
    got, _ = tckpt.restore(str(tmp_path))
    np.testing.assert_array_equal(_bits(got["params"]["final_norm"]), _bits(params["final_norm"]))


def test_latest_step_and_step_choice(tmp_path):
    root = str(tmp_path)
    assert tckpt.latest_step(root) is None and tckpt.latest_step(root + "/none") is None
    with pytest.raises(FileNotFoundError, match="no committed checkpoint"):
        tckpt.restore(root)
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "l": [np.ones(2, np.float32)]}
    jckpt.save(root, 3, tree)
    jckpt.save(root, 12, jax.tree_util.tree_map(lambda a: a + 1, tree))
    os.makedirs(os.path.join(root, "step_00000099.tmp"))  # staged, never committed
    os.makedirs(os.path.join(root, "step_00000050"))  # no manifest: not committed
    assert tckpt.latest_step(root) == jckpt.latest_step(root) == 12
    latest, _ = tckpt.restore(root)
    older, _ = tckpt.restore(root, step=3)
    np.testing.assert_array_equal(latest["w"].numpy(), tree["w"] + 1)
    np.testing.assert_array_equal(older["w"].numpy(), tree["w"])
    assert isinstance(older["l"], list) and older["l"][0].tolist() == [1.0, 1.0]


def test_reader_imports_neither_jax_nor_ml_dtypes(tmp_path):
    jckpt.save(str(tmp_path), 1, {"params": _reference_params("gemma3-1b", "bfloat16")})
    script = textwrap.dedent(f"""
        import sys
        from repro_torch.train import checkpoint
        tree, _ = checkpoint.restore({str(tmp_path)!r})
        leaf = tree["params"]["embed"]["embedding"]
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
        print(leaf.dtype, bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split()[0] == "torch.bfloat16"


def _cli_lines(capsys, argv):
    from repro_torch.launch import serve

    serve.main(argv)
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_serve_ckpt_dir_serves_as_the_bridge_and_reference(tmp_path, capsys, dtype):
    arch, n, plen, steps = "gemma3-1b", 4, 12, 6
    params = _reference_params(arch, dtype)
    jckpt.save(str(tmp_path), 1, {"params": params})
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--requests", str(n), "--prompt-len", str(plen), "--steps", str(steps),
            "--max-batch", "2"]
    lines = _cli_lines(capsys, argv)
    assert lines[0] == f"restored weights from {tmp_path}"
    # the in-process bridge of the same tree, through the same scheduler
    cfg = get_config(arch, reduced=True)
    kw = dict(prompt_range=(plen // 2, plen + 1), steps_range=(steps // 2, steps + 1), seed=0)
    requests = synthetic_requests(cfg.vocab_size, n, **kw)
    with Runtime("torchdev", device="cpu") as rt:
        sched = ContinuousBatchingScheduler(
            build(cfg), params_from_jax(cfg, params, device="cpu", dtype=torch.float32),
            runtime=rt, max_batch=2, max_len=plen + steps)
        want = sched.serve(requests)
    for r in requests:
        fin = want[r.rid]
        assert f"{fin.rid}: {fin.tokens[:8]}... ({fin.finish_reason})" in lines
    # the reference's scheduler on the checkpoint's weights in its param
    # dtype (fp32), as its `restore` casts them to the template. That cast
    # fails on bf16 leaves, which `np.load` returns as 2-byte void, so the
    # bf16 case casts the saved tree in memory instead
    jcfg = jax_get_config(arch, reduced=True)
    jmodel = jax_build(jcfg)
    if dtype == "float32":
        template, _ = jmodel.init(jax.random.PRNGKey(0))
        restored, _ = jckpt.restore(str(tmp_path), {"params": template})
        jparams = jax.tree_util.tree_map(jnp.asarray, restored["params"])
    else:
        jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a.astype(np.float32)), params)
    ref = JaxScheduler(jmodel, jparams, max_batch=2, max_len=plen + steps).serve(
        jax_synthetic_requests(jcfg.vocab_size, n, **kw))
    assert {rid: f.tokens for rid, f in ref.items()} == {rid: f.tokens for rid, f in want.items()}


def test_launch_serve_without_a_committed_step_inits_seeded_weights(tmp_path, capsys):
    lines = _cli_lines(capsys, ["--reduced", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                                "--requests", "1", "--prompt-len", "4", "--steps", "2"])
    assert not any(ln.startswith("restored weights") for ln in lines)
    assert any(ln.startswith("served 1 requests") for ln in lines)
