"""The steps' FLOPs over the timed window, forward and backward (counted
from the configuration and each batch's canvas), at the card's peaks: the
bf16 convolutions at 989 TFLOP/s, the float32 text head at 67, over the
window's time, in %."""

from harness.readers import mfu


def read(ctx):
    return mfu(ctx)
