"""The ROIAlign forward kernel's share of its roofline: the least time its
inputs need (the tapped map pixels' channels read once, the boxes read,
the output written once, at 3.35 TB/s) over its device time, in %."""

from harness.readers import roofline


def read(ctx):
    return roofline(ctx, "roi_align", "fsod_roi_align_fwd")
