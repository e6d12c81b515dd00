"""The model's share of the card's peak in the traced window: the work of
the window's prefills and decode ticks (`roofline/dense_lm.py`: no
recomputation, only the tokens that decoding slots made) over the window's
length times the peak of the served dtype, in %."""
from perfbench import readers
from perfbench.roofline import dense_lm


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    a = ctx.arch
    flops = sum(dense_lm.prefill_flops(a, sp.meta["prompt"]) for sp in readers.admissions(ctx))
    flops += sum(dense_lm.tick_flops(a, p) for tick in readers.ticks(ctx) for p in tick)
    return flops / (ctx.trace.window_s * ctx.peaks[ctx.config["serve_dtype"]]) * 100.0
