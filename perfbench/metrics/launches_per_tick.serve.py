"""Kernel launches a decode tick: the profiler's host launch calls inside
the window's intervals, over the ticks. A trace that holds no host launch
calls gives nothing to read."""
import bisect

from perfbench import readers


def read(ctx):
    if ctx.trace is None:
        return None
    iv = readers.intervals(ctx)
    n_ticks = sum(sp.meta["ticks"] for sp in iv)
    if not ctx.trace.host_calls:
        readers.warn("launches_per_tick.serve", "the trace holds no host launch calls")
        return None
    starts = sorted(c[1] for c in ctx.trace.host_calls)
    if not n_ticks:
        return None
    n = sum(bisect.bisect_right(starts, sp.end) - bisect.bisect_left(starts, sp.start)
            for sp in iv)
    return n / n_ticks
