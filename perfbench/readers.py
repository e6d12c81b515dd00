"""What the per-layer readers (`metrics/*.py`) share: the window's spans
by kind, the decode work of each tick, device seconds of named kernels, the
cell's weight dtype."""
from __future__ import annotations

from typing import Iterator, List, Tuple

from perfbench import bench


def admissions(ctx) -> List[bench.Span]:
    return bench.spans_in(ctx.spans, "admit", ctx.t0, ctx.t1)


def intervals(ctx) -> List[bench.Span]:
    return bench.spans_in(ctx.spans, "interval", ctx.t0, ctx.t1)


def ticks(ctx) -> Iterator[List[int]]:
    """For each tick of the window's intervals, the position each decoding
    slot attends up to (its prompt plus the tokens it had, less one)."""
    for sp in intervals(ctx):
        for i in range(sp.meta["ticks"]):
            yield [p + n0 - 1 + i for p, n0, made in sp.meta["slots"] if made > i]


def kernel_seconds(ctx, match) -> Tuple[float, int]:
    """Device seconds and calls of the window's kernels that `match`."""
    ops = [op for op in ctx.trace.ops_named(match) if ctx.t0 <= op[1] <= ctx.t1]
    return sum(min(e, ctx.t1) - s for _, s, e in ops), len(ops)


def warn(metric: str, msg: str) -> None:
    bench.log(f"{metric}: {msg}")


def steps(ctx) -> List[bench.Span]:
    return bench.spans_in(ctx.spans, "step", ctx.t0, ctx.t1)


def elem_bytes(dtype: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[dtype]


def idle_percent(ctx):
    if ctx.trace is None:
        return None
    return (1.0 - ctx.trace.busy_s() / ctx.trace.window_s) * 100.0
