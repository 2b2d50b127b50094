"""Device ms per image of the kernels launched from the RPN head's forward
to the ROI heads' (the head, decode, top-k and the NMS kernel)."""

from harness.readers import range_ms


def read(ctx):
    return range_ms(ctx, "rpn", "images")
