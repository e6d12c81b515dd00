"""The plain reference agrees with the port at the port's REDUCED sizes on
the CPU (fp32, where the port's kernels are their plain versions), and a
whole small run of each cell comes out correct."""
import itertools
import time
import types

import numpy as np
import pytest
import torch

from perfbench import bench, testing, weights
from perfbench.drivers import serve_closed_loop, train_steps
from perfbench.reference import dense_lm


@pytest.mark.parametrize("cell", [testing.SERVE, testing.TRAIN])
def test_prefill_logits_match_the_port(cell):
    from repro_torch.configs import ArchConfig
    from repro_torch.models import build

    job = testing.small_job(cell)
    arch = ArchConfig(**job.config["arch"])
    flat = weights.make_flat(arch, 5, "cpu", torch.float32)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(1, arch.vocab_size, 37))
    with torch.no_grad():
        port, _ = build(arch).make_prefill(64)(weights.to_tree(flat), {"tokens": tokens[None]})
    ref = dense_lm.Model(job.ref_arch(), flat).logits_rows([tokens], [torch.tensor([36])])[0]
    torch.testing.assert_close(port[0], ref[0], rtol=1e-4, atol=1e-4)


def test_a_small_serving_run_is_correct(monkeypatch):
    # a clock that advances 10 ms a reading: the window holds the same
    # iterations however loaded the machine is
    start = time.perf_counter()
    ticks = itertools.count()
    monkeypatch.setattr(serve_closed_loop, "time", types.SimpleNamespace(
        perf_counter=lambda: start + 0.01 * next(ticks)))
    job = testing.small_job(testing.SERVE)
    out = serve_closed_loop.run(job)
    assert out.failed == 0 and out.attempted > 0
    gap, limit = out.compared["logit_gap"]
    assert gap < 1e-4 and bench.judge(out.compared)
    assert out.e2e["output_tok_s"] > 0 and out.e2e["setup_s"] > 0


def test_a_small_training_run_is_correct():
    job = testing.small_job(testing.TRAIN)
    out = train_steps.run(job)
    assert out.failed == 0 and out.attempted > 0
    assert all(v < 1e-4 for v, _ in out.compared.values())
    assert bench.judge(out.compared)
    assert out.e2e["train_tok_s"] > 0
