"""Flash backward's share of its roofline in the window's steps: the bound
of each call (`roofline/flash_bwd.py`: one call a layer a microbatch a
step, at the step's shapes) summed, over the device time of the backward's
kernels the trace holds, in %."""
from perfbench import readers
from perfbench.roofline import flash_bwd, peaks


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    a, mix = ctx.arch, ctx.traffic
    dtype = a.compute_dtype
    hd = a.head_dim or a.d_model // a.num_heads
    micro = mix.get("microbatches", 1)
    f, b = flash_bwd.work(B=mix["batch"] // micro, Sq=mix["seq_len"], Skv=mix["seq_len"],
                          H=a.num_heads, KV=a.num_kv_heads, hd=hd,
                          elem=readers.elem_bytes(dtype))
    calls = len(readers.steps(ctx)) * a.num_layers * micro
    seconds, kernels = readers.kernel_seconds(ctx, flash_bwd.matches)
    if not calls or ctx.counters.get("flash_attention_bwd") != calls or kernels < 3 * calls:
        readers.warn("flash_bwd_roofline.train", f"{calls} calls expected, "
                     f"{ctx.counters.get('flash_attention_bwd')} launched, {kernels} kernels "
                     "in the trace (three or four a call)")
        return None
    return calls * peaks.bound_s(f, b, ctx.peaks, dtype) / seconds * 100.0
