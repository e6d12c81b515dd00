"""The metric arithmetic on synthetic records and a synthetic trace."""
import types

import pytest

from perfbench import bench
from perfbench.drivers.serve_closed_loop import Rec, end_to_end
from perfbench.roofline import paged_decode, peaks

import numpy as np


def _rec(i, t_submit, t_first, step_times, budget=4):
    r = Rec(f"r{i}", i, np.zeros(10, np.int32), budget, t_submit)
    r.t_first = t_first
    r.arrivals = [(t_first, 1)] + [(t, 1 + j + 1) for j, t in enumerate(step_times)]
    if r.count >= budget:
        r.t_done, r.tokens, r.reason = step_times[-1], [1] * budget, "length"
    return r


def _steady(stall=0.0):
    """Requests i = 0..19 submitted at i, first token 0.1 s later, three more
    tokens a second apart; from t = 10 every event is `stall` s later."""
    def late(t):
        return t + stall if t >= 10 else t

    return [_rec(i, late(i), late(i + 0.1), [late(i + 1.1), late(i + 2.1), late(i + 3.1)])
            for i in range(20)]


def test_rates_and_tails_of_a_steady_window():
    m, submitted, ended = end_to_end(_steady(), 2.0, 12.0)
    assert len(submitted) == 10
    assert m["ttft_p90_ms"] == pytest.approx(100.0)
    assert m["tpot_p95_ms"] == pytest.approx(1000.0)
    assert m["output_tok_s"] == pytest.approx(39 / 10.0)  # events at 2.1 .. 11.1


def test_a_stall_inside_the_window_moves_the_rate_and_the_tail():
    base, _, _ = end_to_end(_steady(), 2.0, 12.0)
    stall, _, _ = end_to_end(_steady(stall=1.5) + [_rec(99, 9.95, 11.5, [12.5, 13.5, 14.5])],
                             2.0, 12.0)
    assert stall["output_tok_s"] < base["output_tok_s"]
    assert stall["ttft_p90_ms"] > base["ttft_p90_ms"]


def test_percentile_interpolates():
    assert bench.percentile([1, 2, 3, 4, 5], 50) == 3
    assert bench.percentile(list(range(11)), 90) == 9
    assert bench.percentile([1.0, 2.0], 95) == pytest.approx(1.95)


def _trace():
    ops = [("gemm", 0.0, 1.0), ("gemm", 0.5, 1.5), ("flash", 3.0, 4.0), ("late", 9.5, 11.0)]
    calls = [("cudaLaunchKernel", 2.5, 2.6), ("cudaLaunchKernel", 8.0, 8.1)]
    return bench.TraceData(device_ops=ops, host_calls=calls, t0=0.0, t1=10.0)


def test_busy_idle_and_breakdown():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(1.5 + 1.0 + 0.5)
    assert bench.top_device_ops(tr, 2) == [["gemm", 2.0], ["flash", 1.0]]
    spans = [bench.Span("admit", 1.6, 4.5), bench.Span("interval", 5.0, 9.4)]
    gaps = dict((k, v) for k, v in bench.idle_gaps(tr, spans))
    assert gaps["admit: cudaLaunchKernel"] == pytest.approx(1.5)
    assert gaps["interval: cudaLaunchKernel"] == pytest.approx(5.5)
    assert sum(gaps.values()) == pytest.approx(10.0 - tr.busy_s())


def _ctx(trace=None):
    arch = types.SimpleNamespace(num_layers=2, d_model=256, num_heads=4, num_kv_heads=1,
                                 head_dim=64, d_ff=512, vocab_size=1000, act="gelu",
                                 compute_dtype="bfloat16")
    spans = [bench.Span("admit", 1.0, 2.0, {"prompt": 1000}),
             bench.Span("admit", 2.0, 2.5, {"prompt": 500}),
             bench.Span("interval", 3.0, 4.0, {"ticks": 2, "slots": [(100, 1, 2), (50, 3, 1)]}),
             bench.Span("interval", 20.0, 21.0, {"ticks": 2, "slots": []})]  # after the window
    return bench.ReadContext(
        cell="granite-20b.code-completion", config={"serve_dtype": "bfloat16"}, traffic={},
        arch=arch, t0=0.0, t1=10.0, spans=spans, counters={}, trace=trace,
        peaks=peaks.for_device("NVIDIA H100 80GB HBM3"))


def test_span_readers():
    ctx = _ctx()
    read = lambda name: bench.metric_reader(name)(ctx)  # noqa: E731
    assert read("prefill_ms_per_ktok.serve") == pytest.approx(1500.0 / 1.5)
    assert read("decode_tick_ms.serve") == pytest.approx(1000.0 / 2)
    # two first tokens at admission, three made in the window's one interval
    assert read("output_tok_s.serve") == pytest.approx((2 + 3) / 10.0)
    assert read("device_idle.serve") is None  # no trace: nothing to read
    assert read("mfu.serve") is None


def test_trace_readers():
    paged = "decode_mma_kernel<64, 4, PagedRows>"
    # two ticks x two layers of paged decode, 1 us each; a launch a kernel
    ops = [(paged, 3.1 + i * 0.1, 3.1 + i * 0.1 + 1e-6) for i in range(4)]
    calls = [("cudaLaunchKernel", 3.05 + i * 0.1, 3.06 + i * 0.1) for i in range(4)]
    ctx = _ctx(bench.TraceData(device_ops=ops, host_calls=calls, t0=0.0, t1=10.0))
    read = lambda name: bench.metric_reader(name)(ctx)  # noqa: E731
    assert read("launches_per_tick.serve") == pytest.approx(4 / 2)
    assert read("device_idle.serve") == pytest.approx(100 * (1 - 4e-6 / 10))
    # tick 0: slots at positions 100 and 52; tick 1: only the first, at 101
    p = ctx.peaks
    want = 2 * sum(peaks.bound_s(*paged_decode.work(valid=v, H=4, KV=1, hd=64, elem=2), p,
                                 "bfloat16") for v in ([101, 53], [102]))
    assert read("paged_decode_roofline.serve") == pytest.approx(100 * want / 4e-6)
    assert read("flash_fwd_roofline.serve") is None  # no flash kernel in this trace
    assert 0 < read("mfu.serve") < 100


def test_launches_per_tick_reads_nothing_without_host_calls():
    paged = "decode_mma_kernel<64, 4, PagedRows>"
    ops = [(paged, 3.1 + i * 0.1, 3.1 + i * 0.1 + 1e-6) for i in range(4)]
    ctx = _ctx(bench.TraceData(device_ops=ops, host_calls=[], t0=0.0, t1=10.0))
    assert bench.metric_reader("launches_per_tick.serve")(ctx) is None
