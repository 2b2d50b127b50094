"""Device ms per step of the kernels launched inside the cross-ROI
attention's forward (its backward runs on autograd's thread, outside the
range), in the traced steps."""

from harness.readers import range_ms


def read(ctx):
    return range_ms(ctx, "attention", "steps")
