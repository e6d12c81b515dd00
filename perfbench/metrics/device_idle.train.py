"""The card's idle share of the traced training window: 1 - the union of
the device operations' intervals over the window's length, in %."""
from perfbench import readers


def read(ctx):
    return readers.idle_percent(ctx)
