"""Data pipeline: a deterministic, checkpointable synthetic token stream
with a HiCR Tasking-frontend prefetcher. Port of `repro/train/data.py`.

The stream's batches are numpy arrays drawn exactly as the reference draws
them (the same generator, seed and calls), so the port and the reference
train on the same tokens. Its state is just (seed, step): restoring a
checkpoint resumes the exact token sequence. Prefetching runs as HiCR tasks
(the port's `frontends/tasking`, coroutine task manager) on `hostcpu`
workers feeding a bounded queue.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.backends import hostcpu
from repro_torch.backends.coroutine import CoroutineComputeManager
from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.frontends.tasking import TaskRuntime


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d):
        return DataState(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticTokenStream:
    """Markov-ish synthetic LM data: deterministic per (seed, step)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeConfig, state: Optional[DataState] = None):
        self.cfg = cfg
        self.shape = shape
        self.state = state or DataState(seed=0, step=0)

    def _batch_for(self, step: int) -> dict:
        rng = np.random.default_rng((self.state.seed << 20) ^ step)
        B, S = self.shape.global_batch, self.shape.seq_len
        V = self.cfg.vocab_size
        # token stream with local structure (repeated spans) so the loss is
        # learnable, not uniform noise
        base = rng.integers(0, V, size=(B, S + 1), dtype=np.int64)
        span = rng.integers(2, 8)
        base[:, span:] = np.where(
            rng.random((B, S + 1 - span)) < 0.5, base[:, :-span], base[:, span:]
        )
        return {
            "tokens": base[:, :-1].astype(np.int32),
            "labels": base[:, 1:].astype(np.int32),
        }

    def next_batch(self) -> dict:
        batch = self._batch_for(self.state.step)
        self.state.step += 1
        return batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


class PrefetchingLoader:
    """Tasking-frontend prefetcher: producer tasks generate upcoming batches
    into a bounded queue; the train loop pops."""

    def __init__(self, stream: SyntheticTokenStream, *, depth: int = 2, workers: int = 2):
        self.stream = stream
        self._q: "queue.Queue[dict]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        topo = hostcpu.HostTopologyManager().query_topology()
        resources = (topo.all_compute_resources() * workers)[:workers]
        self._rt = TaskRuntime(
            worker_compute_manager=hostcpu.HostComputeManager(),
            task_compute_manager=CoroutineComputeManager(),
            worker_resources=resources,
        )
        self._runner = threading.Thread(target=self._run, daemon=True)
        self._next_step = stream.state.step
        self._lock = threading.Lock()

    def _produce_one(self):
        with self._lock:
            step = self._next_step
            self._next_step += 1
        batch = self.stream._batch_for(step)
        while not self._stop.is_set():
            try:
                self._q.put(batch, timeout=0.1)
                return
            except queue.Full:
                continue

    def _run(self):
        while not self._stop.is_set():
            task = self._rt.submit(self._produce_one, name="prefetch")
            # run tasks through the runtime's workers, one at a time
            task.wait(timeout=10)

    def start(self):
        # workers run in service mode (no drain) and execute prefetch tasks
        # as the runner submits them
        self._rt.start_workers()
        self._runner.start()
        return self

    def next_batch(self, timeout: float = 30.0) -> dict:
        batch = self._q.get(timeout=timeout)
        self.stream.state.step += 1
        return batch

    def stop(self):
        self._stop.set()
        self._rt._stop.set()
