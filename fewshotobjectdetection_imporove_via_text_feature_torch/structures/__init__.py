from .instances import Detections, GTInstances, ImageBatch, Proposals

__all__ = ["Detections", "GTInstances", "ImageBatch", "Proposals"]
