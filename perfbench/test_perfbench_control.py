"""The checks catch what they are for, at a size a test run holds: the fp8
control put in the program's place fails the limits, and a run with its
timed path broken underneath comes out not correct (a token altered where
it is produced; a training step that returns its state unchanged; half of
each batch left out, the mean taken over the rest)."""
import types

import numpy as np
import pytest
import torch

from perfbench import bench, testing, weights
from perfbench.drivers import serve_closed_loop, train_steps
from perfbench.requests import ClosedLoopRequests


def _served(job, rounds):
    """The port's paged scheduler serving the mix's first `rounds` rounds
    of requests (its own batch loop: the same work on every run)."""
    from repro_torch.configs import ArchConfig
    from repro_torch.core.runtime import Runtime
    from repro_torch.models import build
    from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

    arch = ArchConfig(**job.config["arch"])
    flat = weights.make_flat(arch, job.seed, "cpu", torch.float32)
    gen = ClosedLoopRequests(job.traffic, job.seed, arch.vocab_size)
    reqs = [Request(f"c{c}-r{r}", gen.prompt(c, r), gen.sizes(c, r)[1])
            for r in range(rounds) for c in range(job.traffic["clients"])]
    sch = job.traffic["scheduler"]
    sched = ContinuousBatchingScheduler(
        build(arch), weights.to_tree(flat), max_batch=sch["max_batch"], max_len=sch["max_len"],
        runtime=Runtime("torchdev", device="cpu"), kv_mode="paged",
        page_size=sch["page_size"], sync_interval=sch["sync_interval"])
    done = sched.serve(reqs)
    return flat, [types.SimpleNamespace(prompt=r.prompt, tokens=done[r.rid].tokens) for r in reqs]


def test_serving_control_fails_the_limit():
    job = testing.small_job(testing.SERVE, d_model=256, num_heads=8, head_dim=32, d_ff=1024)
    flat, sample = _served(job, 4)
    program = serve_closed_loop.widest_gap(job.ref_arch(), flat, sample, "cpu")
    control = serve_closed_loop.widest_gap(job.ref_arch(), flat, sample, "cpu", "fp8")
    assert program < 1e-4
    assert control > job.limits["logit_gap"]


def test_training_control_fails_a_limit():
    job = testing.small_job(testing.TRAIN, d_model=256, num_heads=8, head_dim=32, d_ff=512)
    ref = train_steps.reference_readings(job, job.traffic["check_steps"])
    control = train_steps.reference_readings(job, job.traffic["check_steps"], precision="fp8")
    assert not bench.judge(train_steps.compare(job.limits, control, ref))


def test_altered_tokens_are_not_correct(monkeypatch):
    from repro_torch.serve import batching

    real = batching.PagedSlotDecoder.run_interval

    def altered(self, table):
        toks, done, pos = real(self, table)
        toks = np.where(toks >= 0, (toks + 1) % self.params["embed"]["embedding"].shape[0], toks)
        return toks, done, pos

    monkeypatch.setattr(batching.PagedSlotDecoder, "run_interval", altered)
    out = serve_closed_loop.run(testing.small_job(testing.SERVE))
    assert not bench.judge(out.compared)


def _broken_step(monkeypatch, broken):
    from repro_torch.train import train_step as ts

    real = ts.make_train_step
    monkeypatch.setattr(ts, "make_train_step", lambda *a, **kw: broken(real(*a, **kw)))


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    def unchanged(step):
        def run(params, opt_state, ef, batch):
            _, new_state, _, metrics = step(params, opt_state, ef, batch)
            return params, new_state if int(opt_state["count"]) == 0 else opt_state, ef, metrics
        return run

    _broken_step(monkeypatch, unchanged)
    out = train_steps.run(testing.small_job(testing.TRAIN))
    assert not bench.judge(out.compared)
    assert out.compared["change_gap"][0] == pytest.approx(1.0)


def test_half_the_batch_is_not_correct(monkeypatch):
    def half(step):
        def run(params, opt_state, ef, batch):
            n = batch["tokens"].shape[0] // 2
            return step(params, opt_state, ef, {k: v[:n] for k, v in batch.items()})
        return run

    _broken_step(monkeypatch, half)
    out = train_steps.run(testing.small_job(testing.TRAIN))
    assert not bench.judge(out.compared)
