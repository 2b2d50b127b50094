from .predictor import DefaultPredictor, preprocess_single_image, run_grouped

__all__ = ["DefaultPredictor", "preprocess_single_image", "run_grouped"]
