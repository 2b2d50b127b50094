"""The reference's name for the loaders (defrcn/dataloader/build.py:321,
385), as in the JAX package; they live in ``data.loader``."""

from ..data.loader import (
    build_detection_test_loader,
    build_detection_train_loader,
    get_detection_dataset_dicts,
)
from ..data.mapper import DatasetMapper

__all__ = [
    "build_detection_test_loader",
    "build_detection_train_loader",
    "get_detection_dataset_dicts",
    "DatasetMapper",
]
