"""The port's span recorder (`core/tracing.py`) and the spans its layers
record, on the CPU at the REDUCED gemma3-1b config: off, it reads no clock
and changes nothing; on, the spans nest as the layers call each other, their
meta counts the tokens served, and they hold no tensor."""
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tracing  # noqa: E402
from repro_torch.core.runtime import Runtime  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.serve.scheduler import ContinuousBatchingScheduler  # noqa: E402
from repro_torch.serve.workload import synthetic_requests  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import train_step as ts  # noqa: E402

SYNC = 4


@pytest.fixture(scope="module")
def bundle():
    cfg = get_config("gemma3-1b", reduced=True)
    model = build(cfg)
    return cfg, model, model.init(seed=0, device="cpu")


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.stop()
    yield
    tracing.stop()


def _serve(bundle, traced):
    """A paged `serve()` of 6 mixed requests over 3 slots; (results,
    spans or None)."""
    cfg, model, params = bundle
    reqs = synthetic_requests(cfg.vocab_size, 6, prompt_range=(3, 14), steps_range=(2, 11),
                              seed=3)
    with Runtime("torchdev", device="cpu") as rt:
        sched = ContinuousBatchingScheduler(model, params, max_batch=3, max_len=32, runtime=rt,
                                            kv_mode="paged", page_size=4, sync_interval=SYNC)
        if traced:
            tracing.start()
        try:
            done = sched.serve(reqs)
        finally:
            spans = tracing.stop() if traced else None
    return done, spans


def _train(bundle, traced, microbatches=2):
    """One AdamW step on a (4, 16) batch; (loss, spans or None)."""
    cfg, model, params = bundle
    ocfg = opt_lib.OptimizerConfig(learning_rate=1e-3)
    tcfg = ts.TrainConfig(microbatches=microbatches)
    p, opt_state, ef = ts.init_train_state(model, ocfg, params=params, train_cfg=tcfg)
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (4, 17), generator=g)
    batch = {"tokens": toks[:, :-1].to(torch.int32), "labels": toks[:, 1:].to(torch.int32)}
    step = ts.make_train_step(model, ocfg, tcfg)
    if traced:
        tracing.start()
    try:
        _, _, _, metrics = step(p, opt_state, ef, batch)
    finally:
        spans = tracing.stop() if traced else None
    return float(metrics["loss"]), spans


def _by_id(spans):
    return {s.id: s for s in spans}


def test_off_returns_the_shared_no_op_and_reads_no_clock(bundle, monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read with tracing off")

    monkeypatch.setattr(tracing, "clock", no_clock)
    with tracing.span("x", a=1) as sp:
        sp.note(b=2)
    assert sp is tracing.NO_SPAN and tracing.span("y") is tracing.NO_SPAN
    assert not sp
    _serve(bundle, traced=False)
    _train(bundle, traced=False)
    assert tracing.stop() == []


def test_paged_serve_nests_step_interval_and_unit(bundle):
    _, spans = _serve(bundle, traced=True)
    by_id = _by_id(spans)
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start <= s.end
        if s.parent:
            up = by_id[s.parent]
            assert up.start <= s.start and s.end <= up.end and up.thread == s.thread
    names = {s.name for s in spans}
    assert {"sched.admit", "sched.step", "sched.grow", "sched.harvest", "decoder.prefill",
            "decoder.commit", "decoder.interval", "unit.enqueue"} <= names
    intervals = [s for s in spans if s.name == "decoder.interval"]
    assert intervals
    for iv in intervals:
        assert by_id[iv.parent].name == "sched.step"
        units = [s for s in spans if s.parent == iv.id]
        assert [(u.name, u.meta) for u in units] == [("unit.enqueue",
                                                      {"unit": f"fused_decode_x{SYNC}"})]
    for s in spans:
        if s.name in ("sched.grow", "sched.harvest"):
            assert by_id[s.parent].name == "sched.step"
        if s.name in ("decoder.prefill", "decoder.commit"):
            assert by_id[s.parent].name == "sched.admit"
        if s.name == "unit.enqueue" and by_id[s.parent].name == "decoder.prefill":
            assert s.meta == {"unit": "paged_prefill"}
    steps = [s for s in spans if s.name == "sched.step"]
    assert all(s.meta["ticks"] in (0, SYNC) for s in steps)


def test_step_meta_counts_every_token_served(bundle):
    done, spans = _serve(bundle, traced=True)
    tries = [s for s in spans if s.name == "sched.admit"]
    admits = [s for s in tries if s.meta["admitted"]]
    assert len(admits) < len(tries)  # serve() tries until the table is full
    assert sorted(s.meta["rid"] for s in admits) == sorted(done)
    assert {s.meta["rid"]: s.meta["prompt"] for s in admits} == {
        rid: len(f.prompt) for rid, f in done.items()}
    assert all(s.meta["shared_pages"] == 0 and s.meta["new_pages"] > 0 for s in admits)
    made = {rid: 1 for rid in done}  # the first token comes from the prefill
    finished = []
    for s in (s for s in spans if s.name == "sched.step"):
        for rid, before, n in s.meta["slots"]:
            assert before == made[rid]
            made[rid] += n
        finished += s.meta["finished"]
    assert made == {rid: len(f.tokens) for rid, f in done.items()}
    assert sorted(finished) == sorted(done)


def test_tracing_leaves_the_tokens_and_the_loss_as_they_are(bundle):
    off, _ = _serve(bundle, traced=False)
    on, _ = _serve(bundle, traced=True)
    assert {k: v.tokens for k, v in on.items()} == {k: v.tokens for k, v in off.items()}
    assert _train(bundle, traced=True)[0] == _train(bundle, traced=False)[0]


def test_a_step_of_two_microbatches(bundle):
    _, spans = _train(bundle, traced=True)
    by_id = _by_id(spans)
    (step,) = [s for s in spans if s.name == "train.step"]
    assert step.meta == {"tokens": 4 * 16}
    phases = sorted((s for s in spans if s.parent == step.id), key=lambda s: s.start)
    assert [(s.name, s.meta) for s in phases] == [
        ("train.forward", {"micro": 0}), ("train.backward", {"micro": 0}),
        ("train.forward", {"micro": 1}), ("train.backward", {"micro": 1}),
        ("train.clip", {}), ("train.update", {})]
    assert all(s.id == step.id or by_id[s.parent] is step for s in spans)
    for a, b in zip(phases, phases[1:]):
        assert a.end <= b.start


def test_threads_keep_their_own_parent_stacks():
    gate = threading.Barrier(2, timeout=10)

    def work(tag):
        with tracing.span(f"{tag}.outer"):
            gate.wait()  # both outer spans are open at once
            with tracing.span(f"{tag}.inner"):
                gate.wait()

    tracing.start()
    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    by_name = {s.name: s for s in tracing.stop()}
    for tag in ("a", "b"):
        inner, outer = by_name[f"{tag}.inner"], by_name[f"{tag}.outer"]
        assert inner.parent == outer.id and outer.parent == 0
        assert inner.thread == outer.thread
    assert by_name["a.outer"].thread != by_name["b.outer"].thread


def _plain(value):
    if isinstance(value, (list, tuple)):
        return all(_plain(v) for v in value)
    return isinstance(value, (bool, int, float, str))


def test_no_span_holds_a_tensor(bundle):
    _, serve_spans = _serve(bundle, traced=True)
    _, train_spans = _train(bundle, traced=True)
    for s in serve_spans + train_spans:
        assert all(_plain(v) for v in s.meta.values()), s


def test_spans_closing_after_stop_are_not_returned_by_the_next_start():
    tracing.start()
    with tracing.span("open"):
        assert tracing.stop() == []
    tracing.start()
    assert tracing.stop() == []
