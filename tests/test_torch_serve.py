"""The port's serving slices against the JAX reference.

On `Runtime("torchdev", device="cpu")`, with the reference's weights bridged
in, the port must emit exactly the reference's tokens:

* `ContinuousBatchingScheduler(kv_mode="paged")` on the workloads of
  `tests/test_serve.py::TestPagedScheduler`: mixed lengths with a 4-tick
  sync interval, eos mid-interval, page-availability backpressure;
* `ContinuousBatchingScheduler(kv_mode="dense")` on the mixed-length and
  admission-mid-decode workloads of
  `tests/test_serve.py::TestContinuousBatchingScheduler`;
* the serial `ServeEngine.generate`;
* and the port's dense and paged modes agree with each other.

Mixed-length workloads also run the reference with its Pallas kernels
(interpret mode). Also: the `torchdev` backend and the serving CLI on the
CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro.serve.workload import synthetic_requests as jax_synthetic_requests  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.runtime import Runtime  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request  # noqa: E402
from repro_torch.serve.workload import synthetic_requests  # noqa: E402


@pytest.fixture(scope="module")
def bundle():
    jcfg = jax_get_config("gemma3-1b", reduced=True)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("gemma3-1b", reduced=True)
    tparams = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, (jcfg, jmodel, jparams), (build(cfg), tparams)


@pytest.fixture(scope="module")
def runtime():
    with Runtime("torchdev", device="cpu") as rt:
        yield rt


def _workload(vocab, n, *, seed=0, lo_p=3, hi_p=12, lo_s=2, hi_s=14):
    """`tests/test_serve.py::_workload`: (rid, prompt, max_new_tokens)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(lo_p, hi_p))
        steps = int(rng.integers(lo_s, hi_s))
        prompt = rng.integers(1, vocab, (plen,)).tolist()
        out.append((f"r{seed}-{i}", prompt, steps))
    return out


def _port(bundle, runtime, kv_mode="paged", **kw):
    cfg, _, (model, params) = bundle
    return ContinuousBatchingScheduler(model, params, runtime=runtime, kv_mode=kv_mode, **kw)


def _reference(bundle, *, use_pallas=False, kv_mode="paged", **kw):
    _, (jcfg, jmodel, jparams), _ = bundle
    if use_pallas:
        jmodel = jax_build(jcfg.replace(use_pallas=True))
    return JaxScheduler(jmodel, jparams, kv_mode=kv_mode, **kw)


MIXED = dict(max_batch=4, max_len=64, page_size=16, sync_interval=4)


@pytest.fixture(scope="module")
def mixed_port_results(bundle, runtime):
    cfg = bundle[0]
    reqs = _workload(cfg.vocab_size, 6)
    sched = _port(bundle, runtime, **MIXED)
    results = sched.serve([Request(*r) for r in reqs])
    assert sched.decoder.kv.pages_used == 0  # every eviction freed its pages
    return reqs, results


@pytest.mark.parametrize("use_pallas", [False, True], ids=["oracle", "pallas-interpret"])
def test_mixed_lengths_token_identical_to_reference(bundle, mixed_port_results, use_pallas):
    reqs, got = mixed_port_results
    ref = _reference(bundle, use_pallas=use_pallas, **MIXED)
    want = ref.serve([JaxRequest(*r) for r in reqs])
    assert len({len(r[1]) for r in reqs}) > 1
    for rid, _, steps in reqs:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason == "length"
        assert len(got[rid].tokens) == steps


def test_eos_mid_interval_token_identical_to_reference(bundle, runtime):
    prompt = [7, 3, 9, 1]
    chain = _port(bundle, runtime, max_batch=2, max_len=64, sync_interval=5).serve(
        [Request("c", prompt, 8)])["c"].tokens
    eos = chain[3]
    stop = chain.index(eos)
    want = _reference(bundle, max_batch=2, max_len=64, sync_interval=5).serve(
        [JaxRequest("e", prompt, 8, eos_id=eos)])["e"]
    got = _port(bundle, runtime, max_batch=2, max_len=64, sync_interval=5).serve(
        [Request("e", prompt, 8, eos_id=eos)])["e"]
    assert got.finish_reason == want.finish_reason == "eos"
    assert got.tokens == want.tokens == chain[: stop + 1]


def _drive_backpressure(sched, make_request):
    a = make_request("a", [1] * 10, 20)
    b = make_request("b", [2] * 10, 20)
    trace = [sched.try_admit(a), sched.free_slots > 0 and not sched.try_admit(b)]
    results = {}
    while "a" not in results:
        for fin in sched.step():
            results[fin.rid] = fin
    trace.append(sched.try_admit(b))  # freed pages readmit
    while "b" not in results:
        for fin in sched.step():
            results[fin.rid] = fin
    return trace, {rid: fin.tokens for rid, fin in results.items()}


def test_page_backpressure_matches_reference(bundle, runtime):
    """A pool sized for one request backpressures the second until eviction
    frees its pages; a request larger than the whole pool is unservable."""
    kw = dict(max_batch=4, max_len=48, page_size=16, pool_pages=4, sync_interval=4)
    port = _port(bundle, runtime, **kw)
    trace, got = _drive_backpressure(port, Request)
    ref_trace, want = _drive_backpressure(_reference(bundle, **kw), JaxRequest)
    assert trace == ref_trace == [True, True, True]
    assert got == want
    assert port.decoder.kv.pages_used == 0
    tiny = _port(bundle, runtime, max_batch=2, max_len=48, page_size=16, pool_pages=3,
                 sync_interval=4)
    with pytest.raises(ValueError, match="KV pages"):
        tiny.try_admit(Request("big", [3] * 30, 17))


def test_progress_and_unported_modes(bundle, runtime):
    sched = _port(bundle, runtime, max_batch=2, max_len=32, page_size=16, sync_interval=2)
    assert sched.try_admit(Request("p", [1, 2, 3], 6))
    prog = sched.active_progress()
    assert set(prog.requests) == {"p"} and len(prog.requests["p"]) == 1
    assert prog.pages_used >= 1
    assert prog.pages_free == sched.decoder.kv.capacity - prog.pages_used
    _, _, (model, params) = bundle
    dense = ContinuousBatchingScheduler(model, params, runtime=runtime, max_batch=2, max_len=32)
    assert dense.kv_mode == "dense"  # the reference's default
    assert dense.try_admit(Request("d", [1, 2, 3], 6))
    prog = dense.active_progress()
    assert set(prog.requests) == {"d"} and prog.pages_used is None and prog.free_slots == 1
    # the prefix cache (ported): a radix cache over the pool, a shared
    # layout, and every admission through the tail prefill
    cached = ContinuousBatchingScheduler(model, params, runtime=runtime, kv_mode="paged",
                                         max_batch=2, max_len=32, page_size=8,
                                         prefix_cache=True)
    assert cached.prefix is not None and cached.prefix.pool is cached.decoder.kv
    assert cached.decoder.layout.shared and not cached.decoder.layout.ring
    with pytest.raises(RuntimeError, match="use prefill_prefix"):
        cached.decoder.prefill([1, 2, 3])
    assert cached.try_admit(Request("c", [1, 2, 3], 6))
    prog = cached.active_progress()
    assert prog.prefix["lookups"] == 1 and prog.prefix["hits"] == 0
    assert prog.pages_used >= 1
    assert sched.active_progress().prefix is None and dense.active_progress().prefix is None
    with pytest.raises(ValueError, match="requires kv_mode='paged'"):
        ContinuousBatchingScheduler(model, params, runtime=runtime, prefix_cache=True)
    with pytest.raises(ValueError, match="kv_mode"):
        ContinuousBatchingScheduler(model, params, runtime=runtime, kv_mode="sparse")


def test_synthetic_requests_match_reference():
    kw = dict(prompt_range=(64, 1025), steps_range=(16, 65), seed=0)
    got = synthetic_requests(262144, 16, **kw)
    want = jax_synthetic_requests(262144, 16, **kw)
    assert [(r.rid, list(r.prompt), r.max_new_tokens) for r in got] == \
        [(r.rid, list(r.prompt), r.max_new_tokens) for r in want]


# ---------------------------------------------------------------------------
# dense continuous batching and the serial engine
# ---------------------------------------------------------------------------

DENSE = dict(max_batch=4, max_len=64)


@pytest.fixture(scope="module")
def dense_port_results(bundle, runtime):
    cfg = bundle[0]
    reqs = _workload(cfg.vocab_size, 6)
    sched = _port(bundle, runtime, kv_mode="dense", **DENSE)
    results = sched.serve([Request(*r) for r in reqs])
    assert sched.active_count == 0 and sched.decoder.cache_capacity == 64
    return reqs, results


@pytest.mark.parametrize("use_pallas", [False, True], ids=["oracle", "pallas-interpret"])
def test_dense_mixed_lengths_token_identical_to_reference(bundle, dense_port_results,
                                                          use_pallas):
    reqs, got = dense_port_results
    ref = _reference(bundle, use_pallas=use_pallas, kv_mode="dense", **DENSE)
    want = ref.serve([JaxRequest(*r) for r in reqs])
    assert len({len(r[1]) for r in reqs}) > 1
    for rid, _, steps in reqs:
        assert got[rid].tokens == want[rid].tokens, rid
        assert got[rid].finish_reason == want[rid].finish_reason == "length"
        assert len(got[rid].tokens) == steps


def _drive_admission_mid_decode(sched, make_request, vocab):
    """`tests/test_serve.py::test_admission_mid_decode`: two requests decode
    one tick, a third joins the running batch."""
    early = [make_request(*r) for r in _workload(vocab, 2, seed=1, lo_s=8, hi_s=9)]
    late = make_request(*_workload(vocab, 1, seed=2, lo_s=4, hi_s=5)[0])
    trace = [sched.try_admit(r) for r in early]
    results = {fin.rid: fin.tokens for fin in sched.step()}
    trace += [sched.try_admit(late), sched.active_count]
    while len(results) < 3:
        for fin in sched.step():
            results[fin.rid] = fin.tokens
    return trace, results


@pytest.mark.parametrize("use_pallas", [False, True], ids=["oracle", "pallas-interpret"])
def test_dense_admission_mid_decode_token_identical_to_reference(bundle, runtime, use_pallas):
    vocab = bundle[0].vocab_size
    trace, got = _drive_admission_mid_decode(
        _port(bundle, runtime, kv_mode="dense", **DENSE), Request, vocab)
    ref_trace, want = _drive_admission_mid_decode(
        _reference(bundle, use_pallas=use_pallas, kv_mode="dense", **DENSE), JaxRequest, vocab)
    assert trace == ref_trace == [True, True, True, 3]
    assert got == want


def test_dense_eos_and_cache_ceiling_match_reference(bundle, runtime):
    prompt = [7, 3, 9, 1]
    chain = _port(bundle, runtime, kv_mode="dense", max_batch=2, max_len=64).serve(
        [Request("c", prompt, 8)])["c"].tokens
    eos = chain[3]
    got = _port(bundle, runtime, kv_mode="dense", max_batch=2, max_len=64).serve(
        [Request("e", prompt, 8, eos_id=eos)])["e"]
    want = _reference(bundle, kv_mode="dense", max_batch=2, max_len=64).serve(
        [JaxRequest("e", prompt, 8, eos_id=eos)])["e"]
    assert got.finish_reason == want.finish_reason == "eos"
    assert got.tokens == want.tokens == chain[: chain.index(eos) + 1]
    single = _port(bundle, runtime, kv_mode="dense", max_batch=2, max_len=64)
    assert single.try_admit(Request("one", [1, 2, 3], 1)) and single.active_count == 0
    [fin] = single.step()
    assert fin.rid == "one" and len(fin.tokens) == 1


def test_dense_and_paged_token_identical(bundle, runtime, dense_port_results,
                                         mixed_port_results):
    """The same workload through the port's two KV modes (paged with a
    4-tick sync interval)."""
    dense_reqs, dense = dense_port_results
    paged_reqs, paged = mixed_port_results
    assert dense_reqs == paged_reqs
    assert {rid: f.tokens for rid, f in dense.items()} == \
        {rid: f.tokens for rid, f in paged.items()}


def test_serve_engine_token_identical_to_reference(bundle, runtime):
    cfg, (jcfg, jmodel, jparams), (model, params) = bundle
    rng = np.random.default_rng(5)
    prompts = rng.integers(1, cfg.vocab_size, (3, 9)).astype(np.int32)
    port = ServeEngine(model, params, max_len=40, runtime=runtime)
    seen = []
    got = port.generate(prompts, steps=12, on_first_token=lambda: seen.append(True))
    want = JaxServeEngine(jmodel, jparams, max_len=40).generate(prompts, steps=12)
    assert seen == [True]
    assert got.tokens.shape == (3, 12) and got.tokens.dtype == np.int32
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.prefill_logits, np.asarray(want.prefill_logits, np.float32),
                               atol=1e-4, rtol=0)
    # batching leaks nothing across rows; the serial chain equals the scheduler's
    solo = port.generate(prompts[1:2], steps=12).tokens[0]
    np.testing.assert_array_equal(got.tokens[1], solo)
    sched = _port(bundle, runtime, kv_mode="dense", max_batch=2, max_len=40)
    assert sched.serve([Request("s", prompts[1].tolist(), 12)])["s"].tokens == solo.tolist()
    with pytest.raises(ValueError, match="max_len"):
        port.generate(prompts, steps=40)


# ---------------------------------------------------------------------------
# torchdev backend (CPU binding) and the serving CLI
# ---------------------------------------------------------------------------


def test_torchdev_memcpy_is_in_place_and_execute_returns_a_future(runtime):
    mm, cm = runtime.memory_manager, runtime.communication_manager
    space = mm.memory_spaces()[0]
    src = torch.arange(8, dtype=torch.float32)
    dst = torch.zeros(8, dtype=torch.float32)
    s, d = mm.register_tensor_slot(space, src), mm.register_tensor_slot(space, dst)
    cm.memcpy(d, 4, s, 8, 12).wait()
    assert dst.tolist() == [0, 2, 3, 4, 0, 0, 0, 0]  # the registered tensor itself changed
    cm.fence(0)
    unit = runtime.create_execution_unit(lambda x: x * 2, name="double")
    fut = runtime.submit(unit, src)
    assert fut.result(timeout=5).tolist() == (src * 2).tolist()
    boom = runtime.create_execution_unit(lambda: 1 / 0, name="boom")
    with pytest.raises(ZeroDivisionError):
        runtime.run(boom)
    topo = runtime.query_topology()
    assert topo.devices[0].kind == "cpu" and runtime.processing_unit.context.type == "cpu"


def test_launch_serve_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--reduced", "--device", "cpu", "--kv-mode", "paged", "--requests", "3",
                "--prompt-len", "20", "--steps", "6", "--max-batch", "2", "--sync-interval", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "0 pages used" in out
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel


@pytest.mark.parametrize("argv", [["--mode", "serial"], ["--kv-mode", "dense"], []],
                         ids=["serial", "dense", "defaults"])
def test_launch_serve_serial_and_dense_on_cpu(capsys, argv):
    from repro_torch.launch import serve

    serve.main(["--reduced", "--device", "cpu", "--requests", "3", "--prompt-len", "12",
                "--steps", "5", "--max-batch", "2", *argv])
    out = capsys.readouterr().out
    mode = "serial" if "serial" in argv else "continuous"
    assert "served 3 requests" in out and f"mode={mode}" in out
    if mode == "continuous":
        assert "kv_mode=dense" in out and "pages used" not in out
    assert set(ops.launch_counts().values()) == {0}
