"""Device ms per image of the kernels launched from the ROI heads' forward
to the detections (ROIAlign, res5, the predictor, the final NMS)."""

from harness.readers import range_ms


def read(ctx):
    return range_ms(ctx, "roi_heads", "images")
