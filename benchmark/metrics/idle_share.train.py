"""The device idle share of the traced training steps: 1 - (the union of
the intervals of kernels, copies and sets) / the traced window, in %."""

from harness.readers import idle_share


def read(ctx):
    return idle_share(ctx)
