"""The ROIAlign backward kernel's share of its roofline: the least time its
inputs need (the output gradient of every bin that reads the map read
once, the boxes read, the feature gradient written once, at 3.35 TB/s)
over its device time in the traced steps, in %."""

from harness.readers import roofline


def read(ctx):
    return roofline(ctx, "roi_align_backward", "fsod_roi_align_bwd")
