"""The NMS kernels' share of their roofline: the least time the IoU tests
the data needs take (12 float32 operations each at 67 TFLOP/s), or
reading the boxes at 3.35 TB/s if longer, over their device time, in %."""

from harness.readers import roofline


def read(ctx):
    return roofline(ctx, "nms_sorted", "fsod_nms")
