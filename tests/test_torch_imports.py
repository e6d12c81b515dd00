"""The port stands alone: importing every module of `repro_torch` pulls in
neither JAX nor the JAX package, and its `torchdev` runtime never falls back
to the CPU on its own."""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.runtime import Runtime  # noqa: E402

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
        print(len(names), bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 25  # every module of the package was imported


def test_torchdev_without_a_device_never_picks_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Runtime("torchdev")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Runtime("torchdev", device="cuda")
    with Runtime("torchdev", device="cpu") as rt:  # the CPU only when asked
        assert rt.processing_unit.context == torch.device("cpu")
