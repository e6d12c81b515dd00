"""The port's serving slice against the JAX reference.

The port's `ContinuousBatchingScheduler(kv_mode="paged")` on
`Runtime("torchdev", device="cpu")` must emit exactly the tokens of the
reference's paged scheduler, with the reference's weights bridged in, on the
workloads of `tests/test_serve.py::TestPagedScheduler`: mixed lengths with a
4-tick sync interval, eos mid-interval, page-availability backpressure. One
workload also runs the reference with its Pallas kernels (interpret mode).
Also: the `torchdev` backend and the serving CLI on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build as jax_build  # noqa: E402
from repro.serve.scheduler import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serve.scheduler import Request as JaxRequest  # noqa: E402
from repro.serve.workload import synthetic_requests as jax_synthetic_requests  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.runtime import Runtime  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request  # noqa: E402
from repro_torch.serve.workload import synthetic_requests  # noqa: E402


@pytest.fixture(scope="module")
def bundle():
    jcfg = jax_get_config("gemma3-1b", reduced=True)
    jmodel = jax_build(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("gemma3-1b", reduced=True)
    tparams = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams))
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


def _port(bundle, runtime, **kw):
    cfg, _, (model, params) = bundle
    return ContinuousBatchingScheduler(model, params, runtime=runtime, kv_mode="paged", **kw)


def _reference(bundle, *, use_pallas=False, **kw):
    _, (jcfg, jmodel, jparams), _ = bundle
    if use_pallas:
        jmodel = jax_build(jcfg.replace(use_pallas=True))
    return JaxScheduler(jmodel, jparams, kv_mode="paged", **kw)


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
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ContinuousBatchingScheduler(model, params, runtime=runtime, kv_mode="dense")
    with pytest.raises(NotImplementedError, match="not ported yet"):
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

    serve.main(["--reduced", "--device", "cpu", "--requests", "3", "--prompt-len", "20",
                "--steps", "6", "--max-batch", "2", "--sync-interval", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "0 pages used" in out
    assert ops.launch_counts() == {"flash_attention": 0, "paged_decode_attention": 0}
