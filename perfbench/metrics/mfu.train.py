"""The model's share of the card's peak in the traced training window: the
work of the window's steps (`roofline/dense_lm.py`: forward and backward,
no recomputation) over the window's length times the peak of the compute
dtype, in %."""
from perfbench import readers
from perfbench.roofline import dense_lm


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    mix = ctx.traffic
    n = len(readers.steps(ctx))
    flops = n * dense_lm.train_step_flops(ctx.arch, mix["batch"], mix["seq_len"])
    return flops / (ctx.trace.window_s * ctx.peaks[ctx.arch.compute_dtype]) * 100.0
