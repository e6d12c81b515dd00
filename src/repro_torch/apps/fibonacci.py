"""Test Case 3 (paper §5.3): fine-grained tasking — naive recursive
Fibonacci as a task DAG.

F(n) spawns F(n-1) and F(n-2) as independent tasks until F(1)/F(0); the
total task count is 2·F(n+1)−1 (150 049 for n=24). Parent tasks never block
a worker: completion propagates through continuation callbacks (the
HiCR Tasking frontend's settable state-change callbacks), so the benchmark
measures pure scheduling/context-switch overhead, exactly the paper's
intent. Two variants, mirroring the paper:

* ``task_manager="threads"``   — hostcpu compute manager (nOS-V analog:
  every task body runs on a worker's task processing unit).
* ``task_manager="coroutine"`` — suspendable generator tasks (the
  Pthreads+Boost analog with user-level context switching).
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from repro_torch.backends import coroutine, hostcpu
from repro_torch.frontends.tasking import TaskRuntime


def expected_tasks(n: int) -> int:
    a, b = 0, 1
    for _ in range(n + 1):
        a, b = b, a + b
    return 2 * a - 1  # 2*F(n+1) - 1   (F(24) -> 150 049, as in the paper)


def fib_reference(n: int) -> int:
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a


class _Node:
    """Continuation cell: parent completes when both children reported."""

    __slots__ = ("remaining", "value", "parent", "lock")

    def __init__(self, parent: Optional["_Node"]):
        self.remaining = 2
        self.value = 0
        self.parent = parent
        self.lock = threading.Lock()

    def report(self, v: int, done_cb):
        node = self
        while node is not None:
            with node.lock:
                node.value += v
                node.remaining -= 1
                if node.remaining > 0:
                    return
                v = node.value
            node = node.parent
            if node is None:
                done_cb(v)


def run_fibonacci(n: int, *, workers: int = 4, task_manager: str = "coroutine",
                  timeout: float = 600.0) -> dict:
    """Returns {value, tasks, seconds, per_worker}."""
    topo = hostcpu.HostTopologyManager().query_topology()
    resources = (topo.all_compute_resources() * workers)[:workers]
    tcm = (
        coroutine.CoroutineComputeManager()
        if task_manager == "coroutine"
        else hostcpu.HostComputeManager()
    )
    rt = TaskRuntime(
        worker_compute_manager=hostcpu.HostComputeManager(),
        task_compute_manager=tcm,
        worker_resources=resources,
    )
    result_box = {}
    done = threading.Event()

    def finish(v):
        result_box["value"] = v
        done.set()

    def spawn(m: int, node: Optional[_Node]):
        if task_manager == "coroutine":
            def body(m=m, node=node):
                yield  # a real suspension point: measures context switching
                if m < 2:
                    _Node.report(node, m, finish) if node else finish(m)
                    return m
                child = _Node(node)
                spawn(m - 1, child)
                spawn(m - 2, child)
                return m
        else:
            def body(m=m, node=node):
                if m < 2:
                    _Node.report(node, m, finish) if node else finish(m)
                    return m
                child = _Node(node)
                spawn(m - 1, child)
                spawn(m - 2, child)
                return m

        rt.submit(body, name=f"fib-{m}")

    t0 = time.monotonic()
    rt.start_workers()
    spawn(n, None)  # one root task -> total task count is 2·F(n+1)−1
    if not done.wait(timeout):
        rt.stop_workers()
        raise TimeoutError(f"fib({n}) did not finish in {timeout}s")
    rt.stop_workers()
    dt = time.monotonic() - t0
    return {
        "value": result_box["value"],
        "tasks": rt._finished,
        "seconds": dt,
        "per_worker": [w.executed_tasks for w in rt.workers],
    }
