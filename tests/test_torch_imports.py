"""The port stands alone: importing every module of `repro_torch` pulls in
neither JAX nor the JAX package, and neither its `torchdev` runtime nor its
constructors fall back to the CPU on their own."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.runtime import Runtime  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models import xlstm_model  # noqa: E402
from repro_torch.models.attention import paged_layout  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_port_imports_no_jax_and_no_reference():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib", "ml_dtypes"))
                     or m == "repro" or m.startswith("repro."))
        print(len(names), bad, " ".join(names))
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 25  # every module of the package was imported
    names = out.stdout
    for module in ("repro_torch.kernels.linear_scan", "repro_torch.models.ssm",
                   "repro_torch.models.xlstm_model", "repro_torch.configs.xlstm_125m",
                   "repro_torch.models.hybrid", "repro_torch.configs.zamba2_7b",
                   "repro_torch.serve.prefix_cache", "repro_torch.train.checkpoint",
                   "repro_torch.models.moe", "repro_torch.models.vlm",
                   "repro_torch.models.encdec", "repro_torch.configs.grok_1_314b",
                   "repro_torch.configs.kimi_k2_1t_a32b", "repro_torch.configs.paligemma_3b",
                   "repro_torch.configs.whisper_small",
                   # the reference's multi-device modules' counterparts
                   "repro_torch.backends.spmd", "repro_torch.backends.gpu_spec",
                   "repro_torch.kernels.blocked", "repro_torch.kernels.sharded",
                   "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
                   "repro_torch.launch.roofline", "repro_torch.sharding.partition",
                   "repro_torch.sharding.ambient"):
        assert module in names, module


EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
PORTED_EXAMPLES = ("quickstart_torch", "distributed_jacobi_torch", "heterogeneous_inference_torch",
                   "serve_demo_torch", "train_100m_torch")


def test_port_examples_import_no_jax_and_no_reference():
    """Every `examples/*_torch.py` (the five ports of the reference's
    examples among them) imports neither JAX nor the JAX package, and runs
    nothing at import."""
    found = sorted(f[:-3] for f in os.listdir(EXAMPLES) if f.endswith("_torch.py"))
    assert set(PORTED_EXAMPLES) <= set(found), found
    script = textwrap.dedent("""
        import importlib.util, os, sys
        here = sys.argv[1]
        for name in sys.argv[2:]:
            spec = importlib.util.spec_from_file_location(name, os.path.join(here, name + ".py"))
            module = importlib.util.module_from_spec(spec)
            sys.modules[name] = module
            spec.loader.exec_module(module)
            assert callable(module.main), name
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib", "ml_dtypes"))
                     or m == "repro" or m.startswith("repro."))
        print(bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", script, os.path.abspath(EXAMPLES)] + found,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "[]"  # nothing printed: no module ran its program


def test_torchdev_without_a_device_never_picks_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runtime("torchdev")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Runtime("torchdev", device="cuda")
    with Runtime("torchdev", device="cpu") as rt:  # the CPU only when asked
        assert rt.processing_unit.context == torch.device("cpu")


def test_constructors_default_to_the_card_and_never_pick_the_cpu(monkeypatch):
    """With no device named, every constructor allocates on the current CUDA
    device; where there is none it raises, naming ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gemma3-1b", reduced=True)
    model = build(cfg)
    layout = paged_layout(cfg, max_slots=2, max_len=32, page_size=8)
    params = model.init(seed=0, device="cpu")
    tree = {"embed": {"embedding": np.zeros((cfg.vocab_size, cfg.d_model), np.float32)},
            "final_norm": np.zeros((cfg.d_model,), np.float32),
            "layers": {k: np.zeros((cfg.num_layers, 2), np.float32) for k in ("ln1", "ln2")}}
    for make in (lambda **kw: model.init(seed=0, **kw),
                 lambda **kw: transformer.init_lm(cfg, **kw),
                 lambda **kw: params_from_jax(cfg, tree, **kw),
                 lambda **kw: model.init_state(2, 32, **kw),
                 lambda **kw: transformer.init_caches(cfg, 2, 32, **kw),
                 lambda **kw: transformer.init_paged_caches(cfg, layout, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        leaves, stack = [], [make(device="cpu")]  # the CPU only when asked
        while stack:
            node = stack.pop()
            if isinstance(node, torch.Tensor):
                leaves.append(node)
            elif isinstance(node, dict):
                stack.extend(node.values())
            elif isinstance(node, (list, tuple)):
                stack.extend(node)
        assert leaves and all(t.device.type == "cpu" for t in leaves)
    assert params["embed"]["embedding"].device.type == "cpu"


def test_xlstm_constructors_default_to_the_card_and_never_pick_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("xlstm-125m", reduced=True)
    model = build(cfg)
    tree = {"embed": {"embedding": np.zeros((cfg.vocab_size, cfg.d_model), np.float32)},
            "final_norm": np.zeros((cfg.d_model,), np.float32),
            "blocks": [{"norm": np.zeros((cfg.d_model,), np.float32)}]}
    for make in (lambda **kw: model.init(seed=0, **kw),
                 lambda **kw: xlstm_model.init_lm(cfg, **kw),
                 lambda **kw: params_from_jax(cfg, tree, **kw),
                 lambda **kw: model.init_state(2, 32, **kw),
                 lambda **kw: xlstm_model.init_states(cfg, 2, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        leaves = _leaves(make(device="cpu"))  # the CPU only when asked
        assert leaves and all(t.device.type == "cpu" for t in leaves)


def test_hybrid_constructors_default_to_the_card_and_never_pick_the_cpu(monkeypatch):
    from repro_torch.models import hybrid

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("zamba2-7b", reduced=True)
    model = build(cfg)
    for make in (lambda **kw: model.init(seed=0, **kw),
                 lambda **kw: hybrid.init_lm(cfg, **kw),
                 lambda **kw: model.init_state(2, 32, **kw),
                 lambda **kw: hybrid.init_states(cfg, 2, 32, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        leaves = _leaves(make(device="cpu"))  # the CPU only when asked
        assert leaves and all(t.device.type == "cpu" for t in leaves)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "paligemma-3b", "whisper-small"])
def test_moe_vlm_encdec_constructors_default_to_the_card_and_never_pick_the_cpu(
        monkeypatch, arch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(get_config(arch, reduced=True))
    for make in (lambda **kw: model.init(seed=0, **kw),
                 lambda **kw: model.init_state(2, 32, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        leaves = _leaves(make(device="cpu"))  # the CPU only when asked
        assert leaves and all(t.device.type == "cpu" for t in leaves)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [t for v in tree for t in _leaves(v)]


def test_every_reference_module_has_a_counterpart():
    """Every module of the JAX package has one in the port: by the same
    path, or by its named counterpart (`jaxdev` -> `torchdev`, `tpu_spec`
    -> `gpu_spec`)."""
    import pkgutil

    import repro
    import repro_torch

    renamed = {"repro.backends.jaxdev": "repro_torch.backends.torchdev",
               "repro.backends.tpu_spec": "repro_torch.backends.gpu_spec"}
    # the Pallas-only helpers of the reference's kernels stay with them
    ref = {m.name for m in pkgutil.walk_packages(repro.__path__, "repro.")}
    port = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    missing = sorted(m for m in ref
                     if renamed.get(m, "repro_torch." + m[len("repro."):]) not in port)
    assert not missing, missing
