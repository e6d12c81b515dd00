"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source is compiled by `nvcc` for Hopper (`sm_90a`) into an
object file, all sources at once in parallel, and the objects are linked into
one shared library with a plain C interface, loaded with `ctypes`. The build
runs at first use, never at import (the CPU tests import every module and
have no `nvcc`), and uses only the sources in this package. The library lands
in `_build/` beside the package (listed in `.gitignore`), named by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
loads the existing library. A failed build raises.

The wrappers may run on several threads of one process (the serving
fleet's workers): `load` builds once under a lock, and every wrapper counts
its launches through `count_launch`, under one lock shared by all of them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_build_log: str = ""
#: guards the check-then-build in `load`
_load_lock = threading.Lock()
#: guards every wrapper's launch counts (`count_launch`, `ops.reset_launch_counts`)
COUNT_LOCK = threading.Lock()


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(nvcc: str, srcs: List[Path], flags: List[str]) -> str:
    h = hashlib.sha256()
    h.update(nvcc.encode())
    h.update(" ".join(flags).encode())
    for src in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(*, verbose: bool = False) -> Tuple[Path, str]:
    """Compile every source (in parallel) and link the shared library.
    Returns (library path, compiler log). `verbose` adds `-Xptxas -v`, whose
    register / shared-memory / spill report is in the log."""
    nvcc = nvcc_path()
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    flags = ARCH_FLAGS + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    lib_path = BUILD_DIR / f"libreprotorch-{_digest(nvcc, srcs, ARCH_FLAGS + NVCC_FLAGS)}.so"
    if lib_path.exists() and not verbose:
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *flags, "-I", str(CSRC_DIR), "-c", str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            objs.append(obj)
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent build never sees half a file
    return lib_path, log


def load(*, verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process,
    whichever thread asks first; the others wait for that build)."""
    global _lib, _build_log
    with _load_lock:
        if _lib is None:
            path, _build_log = build(verbose=verbose)
            _lib = ctypes.CDLL(str(path))
        return _lib


def count_launch(module_name: str, kind: str) -> None:
    """Count one launch of variant `kind` in the wrapper module
    `module_name`'s `launches` and `variant_launches`, atomically: a bare
    `+=` on a module global can lose an increment between threads."""
    mod = sys.modules[module_name]
    with COUNT_LOCK:
        mod.launches += 1
        mod.variant_launches[kind] += 1


def build_log() -> str:
    """Compiler output of this process's build ('' when it loaded a library
    built earlier without `verbose`)."""
    return _build_log


def check(err: int, what: str) -> None:
    """Raise on a non-zero `cudaError_t` returned by a C entry point."""
    if err != 0:
        fn = load().repro_cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} ({fn(err).decode()})")


@functools.cache
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA `device`: the wave size that the
    wrappers' launch rules compare grids with."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count
