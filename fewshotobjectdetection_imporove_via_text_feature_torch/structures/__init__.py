from .instances import Detections, ImageBatch, Proposals

__all__ = ["Detections", "ImageBatch", "Proposals"]
