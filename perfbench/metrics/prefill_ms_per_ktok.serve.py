"""Host milliseconds an admission takes a thousand prompt tokens: the
harness's span around each `try_admit` that admitted (prefill, commit, the
first token's copy to the host), summed over the window, over the prompt
tokens admitted."""
from perfbench import readers


def read(ctx):
    adm = readers.admissions(ctx)
    tokens = sum(sp.meta["prompt"] for sp in adm)
    if not tokens:
        return None
    return sum(sp.seconds for sp in adm) * 1e3 / (tokens / 1e3)
