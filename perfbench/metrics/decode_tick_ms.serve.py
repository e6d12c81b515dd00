"""Host milliseconds a decode tick: the harness's span around each `step()`
(one fused interval of `sync_interval` ticks, its page growth and harvest)
summed over the window, over the ticks."""
from perfbench import readers


def read(ctx):
    iv = readers.intervals(ctx)
    n = sum(sp.meta["ticks"] for sp in iv)
    if not n:
        return None
    return sum(sp.seconds for sp in iv) * 1e3 / n
