from .builtin import register_all, register_all_voc
from .catalog import DatasetCatalog, MetadataCatalog
from .loader import (
    build_detection_test_loader,
    build_detection_train_loader,
    device_batches,
    get_detection_dataset_dicts,
)
from .mapper import DatasetMapper, pick_bucket, resize_shortest_edge_size

__all__ = [
    "register_all",
    "register_all_voc",
    "DatasetCatalog",
    "MetadataCatalog",
    "build_detection_test_loader",
    "build_detection_train_loader",
    "device_batches",
    "get_detection_dataset_dicts",
    "DatasetMapper",
    "pick_bucket",
    "resize_shortest_edge_size",
]
