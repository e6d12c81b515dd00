"""Flash forward's share of its roofline in the window's prefills: the
bound of each call (`roofline/flash_fwd.py`, from the prompt's shapes: one
call a layer an admission, as the port's launch counter also counts them)
summed, over the device time of the flash forward kernels the trace holds,
in %."""
from perfbench import readers
from perfbench.roofline import flash_fwd, peaks


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    a, dtype = ctx.arch, ctx.config["serve_dtype"]
    hd = a.head_dim or a.d_model // a.num_heads
    adm = readers.admissions(ctx)
    bound = 0.0
    for sp in adm:
        f, b = flash_fwd.work(B=1, Sq=sp.meta["prompt"], Skv=sp.meta["prompt"], H=a.num_heads,
                              KV=a.num_kv_heads, hd=hd, elem=readers.elem_bytes(dtype))
        bound += a.num_layers * peaks.bound_s(f, b, ctx.peaks, dtype)
    calls = len(adm) * a.num_layers
    seconds, kernels = readers.kernel_seconds(ctx, flash_fwd.matches)
    if not calls or kernels != calls or ctx.counters.get("flash_attention") != calls:
        readers.warn("flash_fwd_roofline.serve", f"{calls} calls expected, "
                     f"{ctx.counters.get('flash_attention')} launched, {kernels} in the trace")
        return None
    return bound / seconds * 100.0
