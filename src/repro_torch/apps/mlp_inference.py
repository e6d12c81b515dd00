"""Test Case 2 (paper §5.2): heterogeneous inference. Port of
`repro/apps/mlp_inference.py`.

A 2-layer MLP digit classifier runs the SAME HiCR program on different
compute backends; only the execution-unit kernel implementation changes:

* ``numpy``        — host BLAS matmuls on the `hostcpu` backend (the paper's
  Pthreads+OpenBLAS variant)
* ``torch``        — plain PyTorch products on the `torchdev` device (the
  reference's ``jax`` row; the paper's ACL/NPU variant)
* ``fused_linear`` — the hand-written CUDA `fused_linear` kernel on the
  card, its plain version on a CPU device (the reference's ``pallas`` row;
  the paper's naive OpenCL variant: same math, different codegen path)

Every product runs in full fp32: Table 2's check is identical accuracy
across rows and img-0 scores within 1e-4, which TF32 would break. The
dataset is a deterministic synthetic "digits" set (10 Gaussian blobs in a
64-dim pixel space); the weights are trained once in plain numpy, so every
backend consumes identical weights. `make_dataset` and `train_weights` are
own copies of the reference's: the same numpy calls with the same seeds
give the same arrays bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.managers import ComputeManager
from repro_torch.core.stateless import ComputeResource
from repro_torch.kernels import ops
from repro_torch.models.common import resolve_device

IN_DIM, HID, N_CLASSES = 64, 32, 10


_PROTO_SEED = 1234  # class prototypes are part of the task definition


def make_dataset(n: int = 2000, *, seed: int = 7, noise: float = 2.4):
    """10 fixed class prototypes + per-split Gaussian noise.
    Returns (x (n,64), y (n,))."""
    protos = np.random.default_rng(_PROTO_SEED).normal(
        size=(N_CLASSES, IN_DIM)).astype(np.float32)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, N_CLASSES, size=n)
    x = protos[y] + noise * rng.normal(size=(n, IN_DIM)).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32)


def train_weights(*, seed: int = 3, steps: int = 300, lr: float = 0.05) -> Mapping[str, np.ndarray]:
    """Tiny numpy SGD training pass (done once, offline, like the paper)."""
    x, y = make_dataset(4000, seed=11)
    rng = np.random.default_rng(seed)
    w1 = (rng.normal(size=(IN_DIM, HID)) / np.sqrt(IN_DIM)).astype(np.float32)
    b1 = np.zeros(HID, np.float32)
    w2 = (rng.normal(size=(HID, N_CLASSES)) / np.sqrt(HID)).astype(np.float32)
    b2 = np.zeros(N_CLASSES, np.float32)
    n = x.shape[0]
    for step in range(steps):
        idx = rng.integers(0, n, size=128)
        xb, yb = x[idx], y[idx]
        h = np.maximum(xb @ w1 + b1, 0.0)
        logits = h @ w2 + b2
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        g = p
        g[np.arange(len(yb)), yb] -= 1.0
        g /= len(yb)
        gw2 = h.T @ g
        gb2 = g.sum(0)
        gh = (g @ w2.T) * (h > 0)
        gw1 = xb.T @ gh
        gb1 = gh.sum(0)
        w1 -= lr * gw1; b1 -= lr * gb1; w2 -= lr * gw2; b2 -= lr * gb2
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2}


# ---------------------------------------------------------------------------
# per-backend kernels (the paper: OpenBLAS / ACL precompiled / naive OpenCL)
# ---------------------------------------------------------------------------


def _kernel_numpy(weights, device=None):
    def run(x):
        h = np.maximum(x @ weights["w1"] + weights["b1"], 0.0)
        return h @ weights["w2"] + weights["b2"]

    return run


def _device_weights(weights, device):
    device = resolve_device(device)
    return device, {k: torch.as_tensor(v, device=device) for k, v in weights.items()}


def _kernel_torch(weights, device=None):
    # full fp32 products: TF32 would move img-0 scores past Table 2's 1e-4
    torch.backends.cuda.matmul.allow_tf32 = False
    device, w = _device_weights(weights, device)

    def fwd(x):
        xt = torch.as_tensor(x, device=device)
        h = torch.relu(xt @ w["w1"] + w["b1"])
        return (h @ w["w2"] + w["b2"]).cpu().numpy()

    return fwd


def _kernel_fused_linear(weights, device=None):
    device, w = _device_weights(weights, device)

    def fwd(x):
        # the kernel masks ragged rows itself: no padding of the batch
        xt = torch.as_tensor(x, device=device)
        h = ops.fused_linear(xt, w["w1"], w["b1"], act="relu")
        return ops.fused_linear(h, w["w2"], w["b2"], act="none").cpu().numpy()

    return fwd


KERNELS: Mapping[str, Callable] = {
    "numpy": _kernel_numpy,
    "torch": _kernel_torch,
    "fused_linear": _kernel_fused_linear,
}


@dataclasses.dataclass
class InferenceResult:
    backend: str
    accuracy: float
    img0_score: float  # highest score for the first test image (paper Table 2)
    img0_class: int


def run_inference(
    compute_manager: ComputeManager,
    resource: ComputeResource,
    *,
    kernel: str,
    weights: Mapping[str, np.ndarray],
    batch_size: int = 256,
    n_test: int = 2000,
) -> InferenceResult:
    """The HiCR program: identical for every backend; only the manager and
    the kernel implementation differ (paper Fig. 4 pattern). A torch kernel
    runs on the device of the processing unit the manager initialises."""
    x, y = make_dataset(n_test, seed=99)

    pu = compute_manager.create_processing_unit(resource)
    compute_manager.initialize(pu)
    device: Optional[torch.device] = pu.context if isinstance(pu.context, torch.device) else None
    fwd = KERNELS[kernel](weights, device)
    # kernels are pre-built (the paper's "saved kernels" model)
    unit = compute_manager.create_execution_unit(fwd, name=f"mlp-{kernel}", jit=False)

    preds, img0_score, img0_class = [], None, None
    for lo in range(0, n_test, batch_size):
        state = compute_manager.create_execution_state(unit, x[lo : lo + batch_size])
        compute_manager.execute(pu, state)
        compute_manager.await_(pu)
        logits = state.get_result()
        if lo == 0:
            img0_score = float(np.max(logits[0]))
            img0_class = int(np.argmax(logits[0]))
        preds.append(np.argmax(logits, axis=1))
    compute_manager.finalize(pu)

    acc = float(np.mean(np.concatenate(preds) == y))
    return InferenceResult(kernel, acc, img0_score, img0_class)
