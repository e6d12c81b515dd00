"""One run of one cell: what a driver is given, and what it hands back."""
from __future__ import annotations

import dataclasses
import types
from typing import Dict, Tuple

from perfbench.bench import ReadContext


@dataclasses.dataclass
class Job:
    cell: dict  # the BENCHMARK.json workload entry
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<mix>.json
    limits: dict  # limits/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: str  # "cuda" on the chip; "cpu" only in the CPU tests
    t_start: float  # perf_counter() at process start

    def ref_arch(self) -> types.SimpleNamespace:
        """The config's sizes as a plain namespace, for the reference."""
        return types.SimpleNamespace(**self.config["arch"])


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]  # end-to-end metrics, by name
    attempted: int
    failed: int
    compared: Dict[str, Tuple[float, float]]  # number -> (value, limit)
    memory_peak_bytes: int
    ctx: ReadContext  # for the per-layer readers, the device trace among them
