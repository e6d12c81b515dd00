"""Distributed 3-D Jacobi heat solver (paper Test Case 4, Figs. 10-11) on
the PyTorch port's HiCR layer. Port of `examples/distributed_jacobi.py`.

13-point stencil; single-instance tasked execution and multi-instance
execution with one-sided halo exchange over the localsim fabric. Results
are validated against the numpy oracle. A host program, as the
reference's is: nothing runs on the card.

    PYTHONPATH=src python examples/distributed_jacobi_torch.py [--size 48] [--iters 10]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.apps import jacobi


def solve(size: int, iters: int, out=print) -> dict:
    """The local run on a (1, 2, 2) thread grid and the distributed runs at
    p = 2 and 4, each checked against the oracle at 1e-5. Returns
    {"local": result, 2: result, 4: result}."""
    grid = jacobi.init_grid((size + 2 * jacobi.HALO,) * 3)
    out(f"grid {size}^3, {iters} iterations, 13-point stencil")
    ref = jacobi.jacobi_reference(grid, iters)

    local = jacobi.run_local(grid, iters, thread_grid=(1, 2, 2))
    np.testing.assert_allclose(local["grid"], ref, rtol=1e-5, atol=1e-5)
    out(f"local  (4 workers) : {local['seconds']:.3f}s  {local['gflops']:.2f} GF/s  "
        f"[matches oracle]")
    runs = {"local": local}
    for p in (2, 4):
        dist = jacobi.run_distributed(grid, iters, instances=p)
        np.testing.assert_allclose(dist["grid"], ref, rtol=1e-5, atol=1e-5)
        out(f"dist   (p={p})       : {dist['seconds']:.3f}s  {dist['gflops']:.2f} GF/s  "
            f"[matches oracle]")
        runs[p] = dist
    return runs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    return solve(args.size, args.iters)


if __name__ == "__main__":
    main()
