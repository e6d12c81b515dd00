"""Tasking frontend (paper §4.3): building blocks for task-based runtime
systems — TaskR-lite.

* **Task** — stateful, with settable callbacks notifying state changes
  (e.g. executing → finished). A task's body may be a plain callable or a
  generator; generators suspend at every ``yield`` (requires a task compute
  manager with ``supports_suspension``, i.e. the coroutine backend).
* **Worker** — stateful object running a simple loop that calls ``pull()``,
  a user-defined scheduling function returning the next task (or None).
* **TaskRuntime** — wires the two together. Takes two, possibly distinct,
  compute managers: one for workers, one for tasks (paper: "managing
  scheduling on the CPU, while executing tasks directly on an accelerator").

Used for real by the training framework's host-side data pipeline
(repro_torch.train.data) and by the Fibonacci/Jacobi paper benchmarks.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Deque, Optional, Sequence

from repro_torch.core.definitions import ExecutionStateStatus
from repro_torch.core.managers import ComputeManager
from repro_torch.core.stateless import ComputeResource


class Task:
    """A schedulable unit of work with lifecycle callbacks."""

    __slots__ = (
        "fn", "args", "kwargs", "name", "state", "result", "error",
        "on_start", "on_suspend", "on_finish", "_exec_state", "_done",
    )

    def __init__(self, fn: Callable, *args, name: str = "task", **kwargs):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = name
        self.state = "created"
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.on_start: Optional[Callable[[Task], None]] = None
        self.on_suspend: Optional[Callable[[Task], None]] = None
        self.on_finish: Optional[Callable[[Task], None]] = None
        self._exec_state = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self.state == "finished"

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def get(self):
        self.wait()
        if self.error is not None:
            raise self.error
        return self.result


class Worker:
    """A worker: a loop pulling tasks from a user scheduling function.

    The loop itself is an execution state on the *worker* compute manager;
    the tasks it advances are execution states on the *task* compute manager.
    """

    def __init__(
        self,
        index: int,
        runtime: "TaskRuntime",
        resource: ComputeResource,
    ):
        self.index = index
        self.runtime = runtime
        self.resource = resource
        self.executed_tasks = 0

    def loop(self):
        rt = self.runtime
        tcm = rt.task_compute_manager
        task_pu = tcm.create_processing_unit(self.resource)
        tcm.initialize(task_pu)
        while not rt._stop.is_set():
            task = rt.pull(self)
            if task is None:
                if rt._drain and rt.pending_count() == 0:
                    break
                time.sleep(0)
                continue
            self._advance(task, tcm, task_pu)
        tcm.finalize(task_pu)
        return self.executed_tasks

    def _advance(self, task: Task, tcm: ComputeManager, task_pu):
        if task._exec_state is None:
            unit = tcm.create_execution_unit(task.fn, name=task.name)
            task._exec_state = tcm.create_execution_state(unit, *task.args, **task.kwargs)
            task.state = "executing"
            if task.on_start:
                task.on_start(task)
        if getattr(tcm, "supports_suspension", False):
            finished = tcm.execute_step(task_pu, task._exec_state)
        else:
            tcm.execute(task_pu, task._exec_state)
            tcm.await_(task_pu)
            finished = True
        if finished:
            self.executed_tasks += 1
            es = task._exec_state
            task.error = es.error
            task.result = es.result
            task.state = "finished"
            self.runtime._finished_one()
            if task.on_finish:
                task.on_finish(task)
            task._done.set()
        else:
            task.state = "suspended"
            if task.on_suspend:
                task.on_suspend(task)
            self.runtime.requeue(task)


class TaskRuntime:
    """Pull-based task scheduler over HiCR compute managers."""

    def __init__(
        self,
        *,
        worker_compute_manager: ComputeManager,
        task_compute_manager: ComputeManager,
        worker_resources: Sequence[ComputeResource],
        pull_fn: Optional[Callable[["TaskRuntime", Worker], Optional[Task]]] = None,
    ):
        self.worker_compute_manager = worker_compute_manager
        self.task_compute_manager = task_compute_manager
        self._queue: Deque[Task] = collections.deque()
        self._qlock = threading.Lock()
        self._stop = threading.Event()
        self._drain = False
        self._submitted = 0
        self._finished = 0
        self._count_lock = threading.Lock()
        self._pull_fn = pull_fn
        self.workers = [Worker(i, self, r) for i, r in enumerate(worker_resources)]

    # -- submission -------------------------------------------------------------
    def submit(self, fn: Callable, *args, name: str = "task", **kwargs) -> Task:
        task = Task(fn, *args, name=name, **kwargs)
        with self._count_lock:
            self._submitted += 1
        with self._qlock:
            self._queue.append(task)
        return task

    def requeue(self, task: Task) -> None:
        with self._qlock:
            self._queue.append(task)

    # -- scheduling --------------------------------------------------------------
    def pull(self, worker: Worker) -> Optional[Task]:
        """The user-definable scheduling function (default: FIFO)."""
        if self._pull_fn is not None:
            return self._pull_fn(self, worker)
        with self._qlock:
            return self._queue.popleft() if self._queue else None

    def pending_count(self) -> int:
        with self._count_lock:
            inflight = self._submitted - self._finished
        return inflight

    def _finished_one(self):
        with self._count_lock:
            self._finished += 1

    # -- execution -----------------------------------------------------------------
    def start_workers(self) -> None:
        """Service mode: start all workers WITHOUT drain semantics — they
        keep pulling until stop_workers(). Used by long-lived services (the
        data-pipeline prefetcher, the serving front door)."""
        wcm = self.worker_compute_manager
        self._drain = False
        self._service = []
        for w in self.workers:
            pu = wcm.create_processing_unit(w.resource)
            wcm.initialize(pu)
            unit = wcm.create_execution_unit(w.loop, name=f"worker-{w.index}")
            state = wcm.create_execution_state(unit)
            wcm.execute(pu, state)
            self._service.append((pu, state))

    def stop_workers(self, *, timeout: float = 30.0) -> None:
        self._stop.set()
        wcm = self.worker_compute_manager
        for pu, state in getattr(self, "_service", ()):
            state.wait(timeout)
            wcm.await_(pu)
            wcm.finalize(pu)

    def run_until_complete(self, *, timeout: float = 300.0) -> dict:
        """Start all workers (as execution states on the worker compute
        manager), drain the queue, and join."""
        wcm = self.worker_compute_manager
        pus, states = [], []
        self._drain = True
        for w in self.workers:
            pu = wcm.create_processing_unit(w.resource)
            wcm.initialize(pu)
            unit = wcm.create_execution_unit(w.loop, name=f"worker-{w.index}")
            state = wcm.create_execution_state(unit)
            wcm.execute(pu, state)
            pus.append(pu)
            states.append(state)
        deadline = time.monotonic() + timeout
        for pu, state in zip(pus, states):
            state.wait(timeout=max(0.0, deadline - time.monotonic()))
            wcm.await_(pu)
            wcm.finalize(pu)
        if any(not s.is_finished() for s in states):
            self._stop.set()
            raise TimeoutError("tasking runtime did not drain in time")
        errs = [s.error for s in states if s.error is not None]
        if errs:
            raise errs[0]
        return {
            "executed": [w.executed_tasks for w in self.workers],
            "total": self._finished,
        }
