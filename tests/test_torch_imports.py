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
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
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
                   "repro_torch.models.xlstm_model", "repro_torch.configs.xlstm_125m"):
        assert module in names, module


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


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [t for v in tree for t in _leaves(v)]
