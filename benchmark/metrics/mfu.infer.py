"""The forward's FLOPs over the timed window (counted from the
configuration and each batch's canvas, res5 over every proposal slot) at
the card's peaks, bf16 at 989 TFLOP/s and the float32 predictor at 67,
over the window's time, in %."""

from harness.readers import mfu


def read(ctx):
    return mfu(ctx)
