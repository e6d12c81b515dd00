"""Small jobs of the benchmark's cells for the CPU tests: the cell's files
as they are, with the config's sizes cut to the port's REDUCED ones (fp32)
and the traffic scaled down, run on the CPU, where the port's kernels are
their plain PyTorch versions."""
from __future__ import annotations

import copy
import time

from perfbench import bench
from perfbench.job import Job

SERVE = "granite-20b.code-completion"
TRAIN = "stablelm-12b-d4.pretrain-4k"

#: the port's REDUCED granite-20b and stablelm-12b (configs/*.py)
REDUCED = {
    SERVE: dict(num_layers=3, d_model=96, num_heads=6, num_kv_heads=1, head_dim=0, d_ff=192,
                vocab_size=512, max_seq_len=256, compute_dtype="float32"),
    TRAIN: dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=0, d_ff=160,
                vocab_size=512, max_seq_len=256, compute_dtype="float32"),
}


def small_job(cell_name: str, *, seed: int = 2**31 + 11, seconds: float = 2.0, **arch) -> Job:
    cell = bench.workload(cell_name)
    cfg = copy.deepcopy(bench.config(cell["config"]))
    cfg["arch"].update(REDUCED[cell_name], **arch)
    mix = copy.deepcopy(bench.traffic(cell["traffic"]))
    if mix["driver"] == "serve_closed_loop":
        cfg["serve_dtype"] = "float32"
        mix.update(clients=4, prompt_tokens=[8, 40], new_tokens=[3, 12], warm_finished=4,
                   check={"served_tokens": 24})
        mix["scheduler"].update(max_batch=4, max_len=56, sync_interval=4)
    else:
        mix.update(batch=2, seq_len=48)
    return Job(cell=cell, config=cfg, traffic=mix, limits=bench.limits(cell_name), seed=seed,
               seconds=seconds, trace=False, device="cpu", t_start=time.perf_counter())
