"""Generated tokens that reached the host in the traced serving window, over
its length: one a request at its admission (the first token's copy), and
each slot's tokens of each interval at its end; from the harness's spans."""
from perfbench import readers


def read(ctx):
    if ctx.t1 <= ctx.t0:
        return None
    made = len(readers.admissions(ctx))
    made += sum(n for sp in readers.intervals(ctx) for _, _, n in sp.meta["slots"])
    return made / (ctx.t1 - ctx.t0)
