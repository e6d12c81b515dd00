"""Paged decode's share of its roofline in the window's ticks: the bound of
each call (`roofline/paged_decode.py`, bytes of the valid KV of the slots
that decode, q and out; one call a layer a tick) summed, over the device
time of the paged decode kernels the trace holds, in %."""
from perfbench import readers
from perfbench.roofline import paged_decode, peaks


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    a, dtype = ctx.arch, ctx.config["serve_dtype"]
    hd = a.head_dim or a.d_model // a.num_heads
    bound, n_ticks = 0.0, 0
    for tick in readers.ticks(ctx):
        n_ticks += 1
        if tick:
            f, b = paged_decode.work(valid=[p + 1 for p in tick], H=a.num_heads,
                                     KV=a.num_kv_heads, hd=hd, elem=readers.elem_bytes(dtype))
            bound += a.num_layers * peaks.bound_s(f, b, ctx.peaks, dtype)
    seconds, calls = readers.kernel_seconds(ctx, paged_decode.matches)
    if calls != n_ticks * a.num_layers:
        readers.warn("paged_decode_roofline.serve",
                     f"{calls} kernels in the trace, {n_ticks * a.num_layers} calls expected")
        return None
    return bound / seconds * 100.0 if seconds else None
