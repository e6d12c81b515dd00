"""Serving under a closed loop: `clients` clients, each sending its next
request the moment its last one finishes, into the port's
`ContinuousBatchingScheduler` on a `torchdev` Runtime, driven through
`try_admit` and `step` as a front door would.

One iteration: admit every waiting request (each admission prefills and
copies the first token to the host), then one `step()` (a fused interval of
`sync_interval` decode ticks; its tokens reach the host at its end), then a
new request from each client whose request finished. The loop starts in
set-up and runs until `warm_finished` requests have finished, so the window
opens on a full, mixed batch; the window closes at the end of the first
step that ends `seconds` after it opened, so it holds whole iterations.

End-to-end metrics (host clock):
* output_tok_s: tokens that reached the host inside the window / its length
  (logged; the result line reports it per layer, `metrics/output_tok_s.serve.py`);
* ttft_p90_ms: over requests submitted inside the window, first token on
  the host - submission;
* tpot_p95_ms: over requests finished inside the window, (last token - first
  token) / (tokens - 1).

Correctness: a sample drawn from the seed of the requests finished in the
window, the longest among them, until `check.served_tokens` tokens; the
reference runs each prompt with its served tokens and the widest gap by
which a served token's logit lies below the reference's best is compared.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import bench, weights
from perfbench.job import Job, Outcome
from perfbench.reference import dense_lm
from perfbench.requests import ClosedLoopRequests


@dataclasses.dataclass
class Rec:
    rid: str
    client: int
    prompt: np.ndarray
    budget: int
    t_submit: float
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    #: (host time, tokens on the host by then) at the first token and each step
    arrivals: List[tuple] = dataclasses.field(default_factory=list)
    tokens: Optional[List[int]] = None
    reason: Optional[str] = None

    @property
    def count(self) -> int:
        return self.arrivals[-1][1] if self.arrivals else 0


def run(job: Job) -> Outcome:
    out, flat, ended = serve(job)
    sample = check_sample(ended, job.seed, job.traffic["check"]["served_tokens"])
    s = time.perf_counter()
    gap = widest_gap(job.ref_arch(), flat, sample, job.device)
    bench.log(f"reference: {len(sample)} requests, {sum(len(r.tokens) for r in sample)} served "
              f"tokens, {time.perf_counter() - s:.1f} s")
    out.compared = {"logit_gap": (gap, job.limits["logit_gap"])}
    return out


def serve(job: Job):
    """The program's part of a run: set-up, the window, the end-to-end
    metrics, and its state freed. Returns (the outcome without its
    comparison, the weights, the requests finished in the window)."""
    from repro_torch.configs import ArchConfig
    from repro_torch.core.runtime import Runtime
    from repro_torch.kernels import ops
    from repro_torch.models import build
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

    clock = time.perf_counter
    mix, sch = job.traffic, job.traffic["scheduler"]
    arch = ArchConfig(**job.config["arch"])
    dtype = getattr(torch, job.config["serve_dtype"])
    flat = weights.make_flat(arch, job.seed, job.device, dtype)
    bench.log(f"weights made at {clock() - job.t_start:.1f} s")
    gen = ClosedLoopRequests(mix, job.seed, arch.vocab_size)
    rt = Runtime("torchdev", device=job.device)
    sched = ContinuousBatchingScheduler(
        build(arch), weights.to_tree(flat), max_batch=sch["max_batch"], max_len=sch["max_len"],
        runtime=rt, kv_mode=sch["kv_mode"], page_size=sch["page_size"],
        sync_interval=sch["sync_interval"])
    K = sch["sync_interval"]

    recs: Dict[str, Rec] = {}
    rounds = [0] * mix["clients"]
    waiting: deque = deque()
    spans: List[bench.Span] = []

    def submit(client: int, now: float) -> None:
        rnd = rounds[client]
        rounds[client] += 1
        _, new = gen.sizes(client, rnd)
        rec = Rec(f"c{client}-r{rnd}", client, gen.prompt(client, rnd), new, now)
        recs[rec.rid] = rec
        waiting.append(rec)

    def iteration() -> List:
        """Admit every waiting request, then one step; returns the step's
        finished requests."""
        while waiting:
            rec = waiting[0]
            s = clock()
            if not sched.try_admit(Request(rec.rid, rec.prompt, rec.budget)):
                raise RuntimeError(f"{rec.rid} was refused: the mix overfills the pool")
            e = clock()
            waiting.popleft()
            rec.t_first = e
            rec.arrivals.append((e, 1))
            spans.append(bench.Span("admit", s, e, {"prompt": len(rec.prompt)}))
        before = {rid: recs[rid].count for rid in sched.active_progress().requests}
        s = clock()
        done = sched.step()
        e = clock()
        progress = sched.active_progress().requests
        for fin in done:
            rec = recs[fin.rid]
            rec.tokens, rec.reason, rec.t_done = fin.tokens, fin.finish_reason, e
            rec.arrivals.append((e, len(fin.tokens)))
        for rid, emitted in progress.items():
            if len(emitted) > recs[rid].count:
                recs[rid].arrivals.append((e, len(emitted)))
        # per active request: (prompt tokens, tokens before, tokens produced)
        slots = [(len(recs[rid].prompt), n0, recs[rid].count - n0) for rid, n0 in before.items()]
        spans.append(bench.Span("interval", s, e, {"slots": slots, "ticks": K}))
        return done

    t_now = clock()
    for c in range(mix["clients"]):
        submit(c, t_now)
    finished = 0
    while finished < mix["warm_finished"]:
        for fin in iteration():
            finished += 1
            submit(recs[fin.rid].client, clock())

    if job.device == "cuda":
        torch.cuda.synchronize()
    bench.log(f"warm: {finished} requests finished; window opens at {clock() - job.t_start:.1f} s")
    counts0 = ops.launch_counts()
    tracer = bench.Trace(torch) if job.trace else None
    t0 = tracer.start() if tracer else clock()
    while True:
        done = iteration()
        t1 = clock()
        if t1 >= t0 + job.seconds:
            break
        for fin in done:
            submit(recs[fin.rid].client, clock())
    trace = tracer.stop(t1) if tracer else None
    counts1 = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() if job.device == "cuda" else 0

    e2e, submitted, ended = end_to_end(recs.values(), t0, t1)
    e2e["setup_s"] = t0 - job.t_start
    failed = sum(1 for r in ended if r.reason != "length" or len(r.tokens) != r.budget)

    ctx = bench.ReadContext(
        cell=job.cell["name"], config=job.config, traffic=job.traffic, arch=arch, t0=t0, t1=t1,
        spans=spans, counters={k: counts1[k] - counts0[k] for k in counts1}, trace=trace,
        peaks=None)

    # the reference runs once the program's state is freed
    del sched, rt
    gc.collect()
    if job.device == "cuda":
        torch.cuda.empty_cache()
    bench.log(f"window: {t1 - t0:.2f} s, {len(ended)} requests finished, "
              f"{e2e['output_tok_s'] * (t1 - t0):.0f} tokens")
    out = Outcome(e2e=e2e, attempted=len(submitted), failed=failed, compared={},
                  memory_peak_bytes=peak, ctx=ctx)
    return out, flat, ended


def end_to_end(recs, t0: float, t1: float):
    """(metrics, requests submitted in the window, requests finished in it)
    of the window [t0, t1] from the requests' records."""
    recs = list(recs)
    tokens_in = 0
    for rec in recs:
        prev = 0
        for t, n in rec.arrivals:
            if t0 <= t <= t1:
                tokens_in += n - prev
            prev = n
    submitted = [r for r in recs if t0 <= r.t_submit < t1]
    ttft = [(r.t_first - r.t_submit) * 1e3 for r in submitted if r.t_first is not None]
    ended = [r for r in recs if r.t_done is not None and t0 <= r.t_done <= t1]
    tpot = [(r.t_done - r.t_first) * 1e3 / (len(r.tokens) - 1) for r in ended
            if len(r.tokens) > 1]
    metrics = {"output_tok_s": tokens_in / (t1 - t0),
               "ttft_p90_ms": bench.percentile(ttft, 90),
               "tpot_p95_ms": bench.percentile(tpot, 95)}
    return metrics, submitted, ended


def check_sample(ended: List[Rec], seed: int, served_tokens: int) -> List[Rec]:
    """The longest finished request (prompt plus served tokens), then others
    in an order drawn from the seed until `served_tokens` served tokens."""
    if not ended:
        return []
    pool = sorted(ended, key=lambda r: r.rid)
    longest = max(pool, key=lambda r: (len(r.prompt) + len(r.tokens), r.rid))
    rest = [r for r in pool if r is not longest]
    order = np.random.default_rng([int(seed) % 2**64, 3]).permutation(len(rest))
    sample, n = [longest], len(longest.tokens)
    for i in order:
        if n >= served_tokens:
            break
        sample.append(rest[int(i)])
        n += len(rest[int(i)].tokens)
    return sample


def reference_rows(sample: List[Rec], device):
    """Each request's prompt + served tokens but the last, and the positions
    whose logits chose a served token."""
    seqs, rows = [], []
    for r in sample:
        toks = np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)])
        seqs.append(torch.as_tensor(toks, device=device))
        P = len(r.prompt)
        rows.append(torch.arange(P - 1, P - 1 + len(r.tokens), device=device))
    return seqs, rows


def widest_gap(arch, flat, sample: List[Rec], device, precision: str = "fp32") -> float:
    """max over the sample's served tokens of (the reference's best logit -
    the served token's logit) at that position. With `precision="fp8"` the
    served token is replaced by the one the fp8 control puts first (the
    control's reading)."""
    if not sample:
        return float("inf")
    dense_lm.strict_fp32()
    seqs, rows = reference_rows(sample, device)
    ref = dense_lm.Model(arch, flat, "fp32").logits_rows(seqs, rows)
    picks = ([torch.as_tensor(r.tokens, device=device) for r in sample] if precision == "fp32"
             else [lg.argmax(-1) for lg in
                   dense_lm.Model(arch, flat, precision).logits_rows(seqs, rows)])
    gap = 0.0
    for lg, pick in zip(ref, picks):
        chosen = torch.gather(lg, -1, pick.long()[:, None])[:, 0]
        gap = max(gap, float((lg.max(-1).values - chosen).max()))
    return gap
