from .predictor import DefaultPredictor, preprocess_single_image, run_grouped
from .trainer import Trainer, make_train_step, step_generators

__all__ = [
    "DefaultPredictor",
    "preprocess_single_image",
    "run_grouped",
    "Trainer",
    "make_train_step",
    "step_generators",
]
