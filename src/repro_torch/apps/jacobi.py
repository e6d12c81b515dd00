"""Test Case 4 (paper §5.4): coarse-grained tasking — 3-D Jacobi heat
solver, 13-point star stencil (center ± {1,2} along each axis), halo
width 2.

Three execution modes, all the same numerical program:

* ``jacobi_reference``    — pure numpy oracle.
* ``run_local``           — one instance, the grid split into lx·ly·lz
  subgrids, one Tasking-frontend task per subgrid per iteration (the
  paper's single-node measurement, Fig. 10).
* ``run_distributed``     — p localsim instances splitting the x-axis;
  per-iteration halo exchange via one-sided PUTs on exchanged global
  memory slots + fence + collective barrier (the paper's multi-node
  scaling measurement, Fig. 11, LPF backend).

FLOP accounting: 13 adds/muls per point per iteration (12 adds + 1 scale),
matching the paper's GFlop/s reporting style.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np

from repro_torch.backends import hostcpu
from repro_torch.backends.localsim import LocalSimWorld
from repro_torch.frontends.tasking import TaskRuntime

HALO = 2
_STAR = [(0, 0, 0)]
for axis in range(3):
    for off in (-2, -1, 1, 2):
        d = [0, 0, 0]
        d[axis] = off
        _STAR.append(tuple(d))
_W = np.float32(1.0 / len(_STAR))

FLOPS_PER_POINT = 13  # 12 adds + 1 multiply


def init_grid(shape: Tuple[int, int, int], *, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.random(shape, dtype=np.float32)


def jacobi_reference(grid: np.ndarray, iterations: int) -> np.ndarray:
    """Pure-numpy oracle. Dirichlet: the outer 2-cell shell stays fixed."""
    a = grid.copy()
    b = grid.copy()
    n = grid.shape
    for _ in range(iterations):
        acc = np.zeros((n[0] - 2 * HALO, n[1] - 2 * HALO, n[2] - 2 * HALO), np.float32)
        for dx, dy, dz in _STAR:
            acc += a[
                HALO + dx : n[0] - HALO + dx,
                HALO + dy : n[1] - HALO + dy,
                HALO + dz : n[2] - HALO + dz,
            ]
        b[...] = a
        b[HALO:-HALO, HALO:-HALO, HALO:-HALO] = acc * _W
        a, b = b, a
    return a


def _update_block(src, dst, lo, hi):
    """dst[interior block] = stencil(src) for the block [lo, hi) given in
    interior coordinates (offset by HALO into the padded array)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    acc = np.zeros((x1 - x0, y1 - y0, z1 - z0), np.float32)
    for dx, dy, dz in _STAR:
        acc += src[
            HALO + x0 + dx : HALO + x1 + dx,
            HALO + y0 + dy : HALO + y1 + dy,
            HALO + z0 + dz : HALO + z1 + dz,
        ]
    dst[HALO + x0 : HALO + x1, HALO + y0 : HALO + y1, HALO + z0 : HALO + z1] = acc * _W


# ---------------------------------------------------------------------------
# single-instance, multi-worker (Fig. 10)
# ---------------------------------------------------------------------------


def run_local(
    grid: np.ndarray,
    iterations: int,
    *,
    thread_grid: Tuple[int, int, int] = (1, 2, 2),
) -> dict:
    """Split into lx·ly·lz blocks; one task per block per iteration."""
    nx, ny, nz = (s - 2 * HALO for s in grid.shape)
    lx, ly, lz = thread_grid
    assert nx % lx == 0 and ny % ly == 0 and nz % lz == 0
    n_workers = lx * ly * lz

    topo = hostcpu.HostTopologyManager().query_topology()
    resources = (topo.all_compute_resources() * n_workers)[:n_workers]
    rt = TaskRuntime(
        worker_compute_manager=hostcpu.HostComputeManager(),
        task_compute_manager=hostcpu.HostComputeManager(),
        worker_resources=resources,
    )
    rt.start_workers()

    a = grid.astype(np.float32).copy()
    b = a.copy()
    blocks = []
    bx, by, bz = nx // lx, ny // ly, nz // lz
    for i in range(lx):
        for j in range(ly):
            for k in range(lz):
                blocks.append(((i * bx, j * by, k * bz), ((i + 1) * bx, (j + 1) * by, (k + 1) * bz)))

    t0 = time.monotonic()
    for _ in range(iterations):
        tasks = [rt.submit(_update_block, a, b, lo, hi, name="block") for lo, hi in blocks]
        for t in tasks:
            t.get()
        a, b = b, a
    dt = time.monotonic() - t0
    rt.stop_workers()

    gflops = nx * ny * nz * iterations * FLOPS_PER_POINT / dt / 1e9
    return {"grid": a, "seconds": dt, "gflops": gflops, "workers": n_workers}


# ---------------------------------------------------------------------------
# distributed (Fig. 11): p instances along x, halo exchange via one-sided put
# ---------------------------------------------------------------------------

_SLOT_TAG = 40_000
_BARRIER_TAG = 41_000


def _rank_program(mgrs, rank, *, full_grid, p, iterations, thread_grid):
    mm, cm = mgrs.memory_manager, mgrs.communication_manager
    space = mm.memory_spaces()[0]
    nx = (full_grid.shape[0] - 2 * HALO) // p
    ny, nz = full_grid.shape[1], full_grid.shape[2]
    plane = ny * nz * 4  # bytes per x-plane

    # local padded block: nx interior planes + 2-halo each side
    a = np.zeros((nx + 2 * HALO, ny, nz), dtype=np.float32)
    a[...] = full_grid[rank * nx : rank * nx + nx + 2 * HALO]
    b = a.copy()
    slots = {0: mm.register_local_memory_slot(space, a, a.nbytes),
             1: mm.register_local_memory_slot(space, b, b.nbytes)}

    # expose both buffers: key = rank * 2 + buffer_index
    gslots = cm.exchange_global_memory_slots(
        _SLOT_TAG, {rank * 2 + i: s for i, s in slots.items()})

    cur, nxt = 0, 1
    bufs = {0: a, 1: b}
    t0 = time.monotonic()
    for it in range(iterations):
        src, dst = bufs[cur], bufs[nxt]
        _update_block(src, dst, (0, 0, 0), (nx, ny - 2 * HALO, nz - 2 * HALO))
        # one-sided halo PUTs into the neighbours' NEXT buffer
        my_dst_slot = slots[nxt]
        if rank > 0:
            left = gslots[(rank - 1) * 2 + nxt]
            # my first interior planes -> left neighbour's high halo
            cm.memcpy(left, (nx + HALO) * plane, my_dst_slot, HALO * plane, HALO * plane)
        if rank < p - 1:
            right = gslots[(rank + 1) * 2 + nxt]
            # my last interior planes -> right neighbour's low halo
            cm.memcpy(right, 0, my_dst_slot, nx * plane, HALO * plane)
        cm.fence(_SLOT_TAG)  # my outgoing puts have landed
        cm.exchange_global_memory_slots(_BARRIER_TAG + it % 2, {})  # all landed
        cur, nxt = nxt, cur
    dt = time.monotonic() - t0
    return {"rank": rank, "block": bufs[cur][HALO:-HALO].copy(), "seconds": dt}


def run_distributed(
    grid: np.ndarray,
    iterations: int,
    *,
    instances: int = 2,
    thread_grid: Tuple[int, int, int] = (1, 1, 1),
    mode: str = "rdma",
) -> dict:
    """p thread-instances over the localsim fabric; returns the reassembled
    interior grid + timing. NOTE: y/z boundaries are fixed (Dirichlet), the
    x-axis is the distributed axis."""
    nx = grid.shape[0] - 2 * HALO
    assert nx % instances == 0

    w = LocalSimWorld(instances, mode=mode)
    results = w.launch(
        lambda mgrs, rank: _rank_program(
            mgrs, rank, full_grid=grid, p=instances,
            iterations=iterations, thread_grid=thread_grid,
        ),
        timeout=600.0,
    )
    w.shutdown()

    interior = np.concatenate([results[r]["block"] for r in range(instances)], axis=0)
    out = grid.copy()
    out[HALO:-HALO] = interior
    seconds = max(results[r]["seconds"] for r in range(instances))
    ny, nz = grid.shape[1] - 2 * HALO, grid.shape[2] - 2 * HALO
    gflops = nx * ny * nz * iterations * FLOPS_PER_POINT / seconds / 1e9
    return {"grid": out, "seconds": seconds, "gflops": gflops, "instances": instances}
