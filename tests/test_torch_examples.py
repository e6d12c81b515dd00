"""The port's examples (`examples/*_torch.py`) against the JAX reference, on
the CPU, and the flash kernels' head-dim rule that the training example
needs.

* `serve_demo_torch`: act 1 (two clients, the channel server over the dense
  scheduler, streamed replies) gives every request the reference
  `ContinuousBatchingScheduler`'s tokens, and act 2 (the fleet) the
  reference `run_fleet`'s, on REDUCED fp32 gemma3-1b weights bridged from
  the reference's `model.init(PRNGKey(0))`;
* `heterogeneous_inference_torch` with ``--device cpu``: the three rows
  agree, and the kernel row is labelled as the plain version;
* `distributed_jacobi_torch`: the local and p = 2, 4 grids match the oracle;
* `quickstart_torch`: its deterministic lines;
* the card examples raise without a card unless asked for the CPU;
* flash at head_dim 80: the wrappers' checks take it (what raises on the
  CPU is the device), and both directions name `simt` for the example's
  fp32 (`wgmma` for bf16 at its widths).
"""
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.serve.router import run_fleet as jax_run_fleet  # noqa: E402
from repro.serve.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro.serve.workload import synthetic_requests as jax_synthetic_requests  # noqa: E402
from repro_torch.apps import jacobi  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


serve_demo = _example("serve_demo_torch")
hetero = _example("heterogeneous_inference_torch")
jacobi_ex = _example("distributed_jacobi_torch")
quickstart = _example("quickstart_torch")


@pytest.fixture(scope="module")
def bundle():
    jcfg = jax_get_config("gemma3-1b", reduced=True)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("gemma3-1b", reduced=True)
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return (jmodel, jparams), (build(cfg), params)


def test_serve_demo_act1_streams_the_reference_schedulers_tokens(bundle):
    (jmodel, jparams), (model, params) = bundle
    server, replies = serve_demo.serve_channels(model, params, "cpu")
    bodies = [b for rank in range(1, 1 + serve_demo.N_CLIENTS)
              for b in serve_demo.client_requests(model.cfg.vocab_size, rank)]
    sched = JaxScheduler(jmodel, jparams, max_batch=serve_demo.MAX_BATCH,
                         max_len=serve_demo.MAX_LEN)
    want = {rid: fin.tokens for rid, fin in sched.serve(
        [JaxRequest(b["id"], b["prompt"], b["steps"]) for b in bodies]).items()}
    assert server["requests"] == len(bodies) == 6 and server["ticks"] >= 1
    assert {rid: tokens for rid, (tokens, _) in replies.items()} == want
    for b in bodies:  # a delta every STREAM_INTERVAL ticks, then the terminal chunk
        tokens, n_chunks = replies[b["id"]]
        assert len(tokens) == b["steps"]
        assert 1 <= n_chunks <= -(-b["steps"] // serve_demo.STREAM_INTERVAL) + 1


def test_serve_demo_act2_fleet_gives_the_reference_fleets_tokens(bundle):
    (jmodel, jparams), (model, params) = bundle
    out = serve_demo.serve_fleet(model, params, "cpu")
    reqs = jax_synthetic_requests(model.cfg.vocab_size, 6, prompt_range=(3, 9),
                                  steps_range=(2, 10), seed=7, rid_prefix="fleet")
    assert [(r.rid, list(r.prompt), r.max_new_tokens) for r in reqs] == [
        (r.rid, list(r.prompt), r.max_new_tokens)
        for r in serve_demo.fleet_requests(model.cfg.vocab_size)]
    want = jax_run_fleet(jmodel, jparams, reqs, n_workers=serve_demo.N_WORKERS,
                         max_batch=serve_demo.MAX_BATCH, max_len=serve_demo.MAX_LEN,
                         stream_interval=serve_demo.STREAM_INTERVAL)
    assert {rid: r["tokens"] for rid, r in out.results.items()} == {
        rid: r["tokens"] for rid, r in want.results.items()}
    assert all(r["finish_reason"] == "length" for r in out.results.values())
    assert out.stats["worker_errors"] == {} and out.stats["restarted"] == []
    assert sum(out.stats["per_worker_settled"].values()) == 6


def test_heterogeneous_inference_rows_agree_and_the_plain_row_says_so(capsys):
    results = hetero.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    labels = [(dev, backend) for dev, backend, _ in results]
    assert labels == [("host-cpu", "numpy"), ("cpu", "torch"), ("cpu", "fused_linear (plain)")]
    assert "fused_linear (plain)" in printed
    accs = {r.accuracy for _, _, r in results}
    scores = [r.img0_score for _, _, r in results]
    assert len(accs) == 1 and min(accs) > 0.85
    assert max(scores) - min(scores) < 1e-4
    assert len(printed.strip().splitlines()) == 4


def test_jacobi_example_matches_the_oracle_locally_and_distributed():
    lines = []
    runs = jacobi_ex.solve(8, 3, out=lines.append)
    ref = jacobi.jacobi_reference(jacobi.init_grid((8 + 2 * jacobi.HALO,) * 3), 3)
    assert sorted(runs, key=str) == [2, 4, "local"]
    for run in runs.values():
        np.testing.assert_allclose(run["grid"], ref, rtol=1e-5, atol=1e-5)
    assert lines[0] == "grid 8^3, 3 iterations, 13-point stencil"
    assert sum("[matches oracle]" in line for line in lines) == 3


def test_quickstart_prints_its_deterministic_lines(capsys):
    quickstart.main([])
    out = capsys.readouterr().out
    assert "Fig.5: message broadcast to 1 memory space(s)" in out
    fig6 = next(line for line in out.splitlines() if line.startswith("Fig.6"))
    n = int(fig6.split(" on ")[1].split()[0])
    assert 1 <= n <= 8 and fig6.endswith(str([i * i for i in range(n)]))
    assert "async API: submit -> futures -> wait_all -> [0, 1, 4, 9, 16, 25]" in out
    assert "world now has 4 instances (elastic ranks: [2, 3])" in out
    assert "torchdev" in out and "spmd" in out and "h100_spec" in out
    assert out.rstrip().endswith("quickstart complete.")


@pytest.mark.parametrize("example", [serve_demo, hetero],
                         ids=["serve_demo", "heterogeneous_inference"])
def test_card_examples_need_a_card_unless_asked_for_the_cpu(monkeypatch, example):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example.main([])


# ---------------------------------------------------------------------------
# flash at head_dim 80 (the training example's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_wrappers_take_head_dim_80(dtype):
    """The checks accept hd 80: on the CPU what refuses is the device."""
    assert 80 in tflash.SUPPORTED_HEAD_DIMS
    q = torch.zeros((4, 33, 8, 80), dtype=dtype)
    k = torch.zeros((4, 33, 2, 80), dtype=dtype)
    with pytest.raises(ValueError, match="CUDA device") as err:
        tflash.flash_attention(q, k, k)
    assert "head_dim" not in str(err.value)
    lse = torch.zeros((4, 8, 33), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA device") as err:
        tflash.flash_attention_backward(q, k, k, q, lse, q)
    assert "head_dim" not in str(err.value)


@pytest.mark.parametrize("hd", [72, 96])
def test_flash_wrappers_refuse_head_dims_not_built(hd):
    q = torch.zeros((1, 8, 2, hd))
    with pytest.raises(ValueError, match=f"head_dim {hd} not in"):
        tflash.flash_attention(q, q[:, :, :1], q[:, :, :1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_80_runs_simt_both_ways(dtype):
    """The example's fp32 stays on simt both ways; its widths in bf16 take
    the tensor cores (tiles padded to 128 columns), forward and backward."""
    q = torch.empty((4, 256, 8, 80), dtype=dtype)
    k = torch.empty((4, 256, 2, 80), dtype=dtype)
    want = "simt" if dtype == torch.float32 else "wgmma"
    assert tflash.variant(q, k, k) == want
    assert tflash.backward_variant(q, k, k) == want
