"""Training steps: the port's `make_train_step` with the launcher's
optimizer and step configs (`launch/train.py`), AdamW over fp32 masters
with the compute in the config's dtype, on batches of `batch` x `seq_len`
tokens drawn from the seed on the device, a different batch every step.
Each step is called directly and waited on (`torch.cuda.synchronize`), not
through a `torchdev` execution unit as the launcher runs it: the unit's
execution state sits in a reference cycle (its Future's poll and waiter
close over it) and holds the step's inputs, so the previous step's
parameters and moments stay alive until Python's cyclic collector runs, and
this stage's step then runs out of the card's memory.

Set-up builds the one training state, runs `check_steps` steps through the
same call and feed, and records what the check compares: each step's loss,
each leaf's first gradient as the optimizer got it (AdamW's first moment
after step 1 / (1 - b1)), and each leaf's change after the last of them.
The window then runs the same state on, step after step, and closes at the
end of the first step that ends `seconds` after it opened.

End-to-end: train_tok_s = tokens of the window's steps / its length.

Correctness: the plain reference runs the same `check_steps` steps from the
same weights and batches in fp32, after the program's state is freed, and
the gaps are compared: the worst step's loss, the worst leaf's first
gradient norm and the worst leaf's change norm (leaves whose reference
gradient is under a thousandth of the median leaf's left out of the
change), each leaf's gap taken against the larger of its reference norm and
the median leaf's.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import torch

from perfbench import bench, weights
from perfbench.job import Job, Outcome
from perfbench.reference import dense_lm

EXCLUDE_BELOW = 1e-3  # of the median leaf's reference gradient norm


def make_batch(arch, mix: dict, seed: int, step: int, device) -> dict:
    """Batch `step` (1-based) of a run: uniform token ids from (seed, step)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7_919 + step) % (2**63 - 1))
    toks = torch.randint(0, arch.vocab_size, (mix["batch"], mix["seq_len"] + 1), generator=g,
                         device=device, dtype=torch.int64)
    return {"tokens": toks[:, :-1].to(torch.int32), "labels": toks[:, 1:].to(torch.int32)}


def norms(tree) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in weights.flatten(tree).items()}


def change_norms(arch, params, seed: int, device) -> Dict[str, float]:
    """Each leaf's |params - initial weights| (the initial ones made again
    from the seed)."""
    first = weights.make_flat(arch, seed, device, torch.float32)
    out = {}
    for k, v in weights.flatten(params).items():
        out[k] = float(torch.linalg.vector_norm(v.float() - first[k]))
    del first
    return out


def run(job: Job) -> Outcome:
    out, program = train(job)
    s = time.perf_counter()
    ref = reference_readings(job, job.traffic["check_steps"])
    bench.log(f"reference: losses {ref['losses']}, {time.perf_counter() - s:.1f} s")
    out.compared = compare(job.limits, program, ref)
    return out


def train(job: Job):
    """The program's part of a run: set-up with its checked steps, the
    window, the end-to-end metrics, and its state freed. Returns (the
    outcome without its comparison, the program's readings: `losses`,
    `grad_norm` and `change`, each leaf's by its path)."""
    from repro_torch.configs import ArchConfig
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    mix = job.traffic
    arch = ArchConfig(**job.config["arch"])
    model = build(arch)
    ocfg = opt_lib.OptimizerConfig(**mix["optimizer"])
    tcfg = ts.TrainConfig(microbatches=mix.get("microbatches", 1))
    params = weights.to_tree(weights.make_flat(arch, job.seed, job.device, torch.float32))
    params, opt_state, ef = ts.init_train_state(model, ocfg, params=params, train_cfg=tcfg)
    train_step = ts.make_train_step(model, ocfg, tcfg)
    sync = torch.cuda.synchronize if job.device == "cuda" else (lambda: None)
    clock = time.perf_counter
    spans: List[bench.Span] = []
    step_no = 0

    def step():
        nonlocal params, opt_state, ef, step_no
        step_no += 1
        batch = make_batch(arch, mix, job.seed, step_no, job.device)
        s = clock()
        params, opt_state, ef, metrics = train_step(params, opt_state, ef, batch)
        loss = float(metrics["loss"])
        sync()
        spans.append(bench.Span("step", s, clock(), {"tokens": mix["batch"] * mix["seq_len"]}))
        return loss

    n_check = mix["check_steps"]
    losses = []
    for i in range(n_check):
        losses.append(step())
        if i == 0:
            first_grad = {k: v / (1 - ocfg.b1) for k, v in norms(opt_state["mu"]).items()}
    changed = change_norms(arch, params, job.seed, job.device)
    bench.log(f"{n_check} checked steps, losses {losses}; window opens at "
              f"{clock() - job.t_start:.1f} s")

    counts0 = ops.launch_counts()
    tracer = bench.Trace(torch) if job.trace else None
    t0 = tracer.start() if tracer else clock()
    window_losses = []
    while True:
        window_losses.append(step())
        t1 = clock()
        if t1 >= t0 + job.seconds:
            break
    trace = tracer.stop(t1) if tracer else None
    counts1 = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if job.device == "cuda" else 0
    in_window = bench.spans_in(spans, "step", t0, t1)
    tokens = sum(s.meta["tokens"] for s in in_window)
    e2e = {"train_tok_s": tokens / (t1 - t0), "setup_s": t0 - job.t_start}
    failed = sum(1 for x in window_losses if not math.isfinite(x))
    ctx = bench.ReadContext(
        cell=job.cell["name"], config=job.config, traffic=mix, arch=arch, t0=t0, t1=t1,
        spans=spans, counters={k: counts1[k] - counts0[k] for k in counts1}, trace=trace,
        peaks=None)

    del params, opt_state, ef, train_step
    gc.collect()
    if job.device == "cuda":
        torch.cuda.empty_cache()
    bench.log(f"window: {t1 - t0:.2f} s, {len(window_losses)} steps; peak {peak} B")
    out = Outcome(e2e=e2e, attempted=len(window_losses), failed=failed, compared={},
                  memory_peak_bytes=peak, ctx=ctx)
    return out, {"losses": losses, "grad_norm": first_grad, "change": changed}


def reference_readings(job: Job, n_steps: int, precision: str = "fp32",
                       rows=None) -> dict:
    """The reference's losses, first gradient norms (clipped, as AdamW
    takes them, and raw) and change norms over `n_steps` steps from the
    seed's weights and batches. `rows`: the batch rows its loss averages."""
    dense_lm.strict_fp32()
    arch = job.ref_arch()
    mix = job.traffic
    p0 = weights.make_flat(arch, job.seed, job.device, torch.float32)
    params = {k: v.clone() for k, v in p0.items()}
    batches = [make_batch(arch, mix, job.seed, i + 1, job.device) for i in range(n_steps)]
    model = dense_lm.Model(arch, params, precision)
    out = dense_lm.train_steps(model, params, batches, mix["optimizer"],
                               mix["objective"]["z_loss"], rows=rows)
    out["change"] = {k: float(torch.linalg.vector_norm(params[k] - p0[k])) for k in params}
    del out["params"]
    return out


def compare(limits: dict, got: dict, ref: dict) -> dict:
    """The three numbers of `got` (the program's readings, or a control's)
    against the reference's, each beside its limit."""
    loss_gap = max(abs(a - b) for a, b in zip(got["losses"], ref["losses"]))
    grad_gap, _ = dense_lm.leaf_gap(got["grad_norm"], ref["grad_norm"])
    raw = ref["grad_norm_raw"]
    med = sorted(raw.values())[len(raw) // 2]
    keep = [k for k, v in raw.items() if v >= EXCLUDE_BELOW * med]
    change_gap, _ = dense_lm.leaf_gap(got["change"], ref["change"], keep)
    return {"loss_gap": (loss_gap, limits["loss_gap"]),
            "grad_gap": (grad_gap, limits["grad_gap"]),
            "change_gap": (change_gap, limits["change_gap"])}
