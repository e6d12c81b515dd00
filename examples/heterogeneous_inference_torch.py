"""Heterogeneous inference (paper Test Case 2, Table 2) on the PyTorch port.
Port of `examples/heterogeneous_inference.py`.

One HiCR inference program; three device stacks selected purely by backend
choice: host numpy (`hostcpu`), eager torch on the card (`torchdev`), and
the hand-written CUDA kernel `csrc/fused_linear.cu` on the card. Accuracy
must agree exactly; the img-0 score to float precision.

    PYTHONPATH=src python examples/heterogeneous_inference_torch.py [--device cpu]

With ``--device cpu`` the two torch rows run on the CPU, where the
fused_linear row is the kernel's plain PyTorch version; its label says so.
"""
from __future__ import annotations

import argparse

from repro_torch.apps import mlp_inference
from repro_torch.backends import hostcpu, torchdev


def rows(device: str) -> list:
    """(device label, backend label, compute manager, compute resource,
    kernel) of the three rows, the torch rows on `device` (``cuda`` without
    a card raises)."""
    host_res = hostcpu.HostTopologyManager().query_topology().all_compute_resources()[0]
    dev_res = torchdev.TorchTopologyManager(device).query_topology().all_compute_resources()[0]
    linear = "fused_linear" if device == "cuda" else "fused_linear (plain)"
    return [
        ("host-cpu", "numpy", hostcpu.HostComputeManager(), host_res, "numpy"),
        (device, "torch", torchdev.TorchComputeManager(device), dev_res, "torch"),
        (device, linear, torchdev.TorchComputeManager(device), dev_res, "fused_linear"),
    ]


def run(device: str, weights=None, n_test: int = 2000) -> list:
    """(device label, backend label, InferenceResult) of every row."""
    weights = mlp_inference.train_weights() if weights is None else weights
    return [(dev, backend, mlp_inference.run_inference(cm, res, kernel=kernel, weights=weights,
                                                       n_test=n_test))
            for dev, backend, cm, res, kernel in rows(device)]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    results = run(args.device)
    print(f"{'device':<10} {'backend':<21} {'accuracy':<10} img-0 score")
    for dev, backend, out in results:
        print(f"{dev:<10} {backend:<21} {out.accuracy:<10.2%} {out.img0_score:.9f}")
    return results


if __name__ == "__main__":
    main()
