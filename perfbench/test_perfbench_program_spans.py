"""The readings of the port's spans (`program_spans.py`) on synthetic windows:
each reading's arithmetic, the check that the device time lies under the
spans, the launch times matched by correlation id, and a small serving job
run with `SpanTrace` in the harness's place on the CPU."""
import time
import types

import pytest

from perfbench import bench, program_spans, testing
from perfbench.program_spans import READINGS, Window


def _spans(*rows):
    """Spans from (id, parent, name, start, end, meta) rows."""
    from repro_torch.core.tracing import Span

    out = []
    for i, parent, name, s, e, meta in rows:
        sp = Span(name, dict(meta))
        sp.id, sp.parent, sp.start, sp.end = i, parent, s, e
        out.append(sp)
    return out


def _serve_window(extra_ops=()):
    """One admission (1,000 prompt tokens), one refused, one step of four
    ticks, in a 10 s window."""
    spans = _spans(
        (1, 0, "sched.admit", 0.5, 1.5, {"prompt": 1000, "admitted": True}),
        (2, 1, "decoder.prefill", 0.55, 1.4, {}),
        (3, 2, "unit.enqueue", 0.6, 0.8, {"unit": "paged_prefill"}),
        (4, 0, "sched.admit", 1.6, 1.7, {"prompt": 500, "admitted": False}),
        (5, 0, "sched.step", 2.0, 4.0, {"ticks": 4}),
        (6, 5, "sched.grow", 2.0, 2.1, {}),
        (7, 5, "decoder.interval", 2.1, 3.9, {}),
        (8, 7, "unit.enqueue", 2.2, 3.0, {"unit": "fused_decode_x4"}),
        (9, 7, "unit.wait", 3.0, 3.8, {"unit": "fused_decode_x4"}),
        (10, 5, "sched.harvest", 3.9, 4.0, {}),
    )
    ops = [("prefill", 0.7, 1.2, 0.7), ("decode", 2.4, 2.9, 2.3), ("decode", 3.0, 3.4, 2.5),
           ("Memcpy DtoH", 3.85, 3.86, 3.85)] + list(extra_ops)
    return Window(spans, ops, 0.0, 10.0)


def _read(w):
    return {name: read(w) for name, read in READINGS.items()}


def test_serve_readings():
    got = _read(_serve_window())
    assert got["dispatch_ms_per_tick.serve"] == pytest.approx(800 / 4)
    assert got["decode_device_ms_per_tick.serve"] == pytest.approx(900 / 4)
    assert got["sched_self_ms_per_tick.serve"] == pytest.approx((2000 - 1800) / 4)
    assert got["prefill_device_ms_per_ktok.serve"] == pytest.approx(500 / 1.0)
    # idle while enqueuing: 0.6-0.7, 2.2-2.4, 2.9-3.0
    assert got["idle_launching.serve"] == pytest.approx(0.4 / 10 * 100)
    assert all(got[k] is None for k in got if k.endswith(".train"))


def test_idle_launching_lies_inside_the_device_idle_share():
    w = _serve_window()
    trace = bench.TraceData(device_ops=[op[:3] for op in w.ops], host_calls=[], t0=0.0, t1=10.0)
    idle = (1.0 - trace.busy_s() / trace.window_s) * 100.0
    assert 0 < READINGS["idle_launching.serve"](w) <= idle


def test_device_readings_need_the_time_under_spans():
    # a long op launched outside every span: 1.5 of 3.91 device seconds tied
    w = _serve_window([("harness", 5.0, 7.5, 4.5)])
    assert w.tied_share() == pytest.approx(1.41 / 3.91)
    got = _read(w)
    assert got["decode_device_ms_per_tick.serve"] is None
    assert got["prefill_device_ms_per_ktok.serve"] is None
    # host readings do not depend on the device time's attribution
    assert got["dispatch_ms_per_tick.serve"] == pytest.approx(200)
    assert got["sched_self_ms_per_tick.serve"] == pytest.approx(50)
    # under 5 % outside: read
    small = _serve_window([("harness", 5.0, 5.05, 4.5)])
    assert small.tied_share() > program_spans.MIN_TIED
    assert READINGS["decode_device_ms_per_tick.serve"](small) == pytest.approx(225)


def _train_window(starts=(1.0, 5.0)):
    """Steps of forward, backward, clip and update starting at `starts`, each
    phase launching one op of a known length; a batch drawn outside each
    step; a 10 s window."""
    rows, ops, i = [], [], 0
    for t in starts:
        step = i = i + 1
        rows.append((step, 0, "train.step", t, t + 3.0, {"tokens": 8192}))
        ops.append(("make_batch", t - 0.1, t - 0.09, t - 0.1))
        for j, (phase, length) in enumerate((("train.forward", 0.6), ("train.backward", 1.2),
                                             ("train.clip", 0.1), ("train.update", 0.3))):
            i += 1
            s = t + 0.5 * j
            rows.append((i, step, phase, s, s + 0.5, {"micro": 0} if j < 2 else {}))
            # the backward's op is launched by another thread: only its time counts
            ops.append((phase + " kernel", s + 0.1, s + 0.1 + length, s + 0.05))
    return Window(_spans(*rows), ops, 0.0, 10.0)


def test_train_phases_add_up_to_the_tied_device_time():
    w = _train_window()
    got = _read(w)
    assert got["forward_ms.train"] == pytest.approx(600)
    assert got["backward_ms.train"] == pytest.approx(1200)
    assert got["clip_ms.train"] == pytest.approx(100)
    assert got["optimizer_ms.train"] == pytest.approx(300)
    phases = sum(got[k] for k in ("forward_ms.train", "backward_ms.train", "clip_ms.train",
                                  "optimizer_ms.train"))
    tied = sum(op[2] - op[1] for sp, op in w.tied() if sp is not None)
    assert phases * 2 == pytest.approx(tied * 1e3)
    assert all(got[k] is None for k in got if k.endswith(".serve"))


def test_device_time_counts_only_steps_wholly_inside_the_window():
    # the third step closes after the window: its forward and backward ops
    # are launched inside it, but the step is not counted, nor are they
    w = _train_window((1.0, 5.0, 9.0))
    assert len(w.named("train.step")) == 2
    got = _read(w)
    assert got["forward_ms.train"] == pytest.approx(600)
    assert got["backward_ms.train"] == pytest.approx(1200)
    assert got["clip_ms.train"] == pytest.approx(100)
    assert got["optimizer_ms.train"] == pytest.approx(300)


def test_an_op_belongs_to_the_innermost_span_that_holds_its_launch():
    w = _serve_window()
    owner = {op[1]: sp.id if sp else None for sp, op in w.tied()}
    assert owner == {0.7: 3, 2.4: 8, 3.0: 8, 3.85: 7}
    assert program_spans.device_ops_by_span(w, 2) == [
        ["unit.enqueue fused_decode_x4", "decode", pytest.approx(0.9)],
        ["unit.enqueue paged_prefill", "prefill", pytest.approx(0.5)]]


def _event(name, start_s, dur_s, corr, cuda, offset):
    ns = int((start_s + offset) * 1e9)
    return types.SimpleNamespace(name=lambda: name, start_ns=lambda: ns,
                                 duration_ns=lambda: int(dur_s * 1e9),
                                 correlation_id=lambda: corr,
                                 device_type=lambda: "cuda" if cuda else "cpu")


def test_launch_times_come_from_the_call_with_the_same_correlation_id():
    torch = types.SimpleNamespace(autograd=types.SimpleNamespace(
        DeviceType=types.SimpleNamespace(CUDA="cuda")))
    t = time.perf_counter()
    off = time.time_ns() * 1e-9 - time.perf_counter()  # the profiler's wall clock
    events = [_event("cudaLaunchKernel", t + 0.01, 1e-5, 7, False, off),
              _event("k", t + 0.02, 0.001, 7, True, off),
              _event("cuLaunchKernelEx", t + 0.03, 1e-5, 8, False, off),
              _event("triton_k", t + 0.04, 0.002, 8, True, off),
              _event("Memset", t + 0.05, 0.001, 9, True, off)]
    ops = program_spans.with_launch(events, torch, t, t + 1.0)
    assert [op[0] for op in ops] == ["k", "triton_k", "Memset"]
    assert ops[0][1:] == pytest.approx((t + 0.02, t + 0.021, t + 0.01), abs=1e-4)
    assert ops[1][3] == pytest.approx(t + 0.03, abs=1e-4)
    assert ops[2][3] is None


def test_a_small_serving_job_with_span_trace_in_the_harness_place(monkeypatch):
    """The drivers run unchanged with `SpanTrace` as their `bench.Trace`: the
    port's spans cover the window, and the recorder is off after it."""
    from perfbench.drivers import serve_closed_loop
    from repro_torch.core import tracing

    class Profile:  # the CPU build records no CUDA activity: an empty trace
        def __init__(self, activities):
            self.profiler = types.SimpleNamespace(
                kineto_results=types.SimpleNamespace(events=lambda: []))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    import torch

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    kept = []

    class Kept(program_spans.SpanTrace):
        def stop(self, t1):
            trace = super().stop(t1)
            kept.append(self.window)
            return trace

    monkeypatch.setattr(bench, "Trace", Kept)
    job = testing.small_job(testing.SERVE, seconds=1.0)
    job.trace = True
    out, _, _ = serve_closed_loop.serve(job)
    (w,) = kept
    assert tracing.span("after") is tracing.NO_SPAN
    assert w.t0 == out.ctx.t0 and w.t1 == out.ctx.t1
    steps = w.named("sched.step")
    assert steps and len(steps) == len(bench.spans_in(out.ctx.spans, "interval", w.t0, w.t1))
    got = _read(w)
    assert got["dispatch_ms_per_tick.serve"] > 0 and got["sched_self_ms_per_tick.serve"] > 0
    assert got["decode_device_ms_per_tick.serve"] is None  # no device time to tie
    assert program_spans.ticks(w) == sum(s.meta["ticks"] for s in bench.spans_in(
        out.ctx.spans, "interval", w.t0, w.t1))
