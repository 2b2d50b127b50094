"""Device ms per image of the kernels launched inside the backbone's
forward (stem to res4), in the traced evaluation batches."""

from harness.readers import range_ms


def read(ctx):
    return range_ms(ctx, "backbone", "images")
