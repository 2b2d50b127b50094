from ..utils.events import print_csv_format, verify_results
from .coco_eval import COCOEvaluator, evaluate_coco_detections
from .evaluator import DatasetEvaluator, inference_on_dataset
from .voc_eval import PascalVOCDetectionEvaluator, voc_ap, voc_eval_class

__all__ = [
    "inference_on_dataset",
    "DatasetEvaluator",
    "COCOEvaluator",
    "evaluate_coco_detections",
    "PascalVOCDetectionEvaluator",
    "voc_ap",
    "voc_eval_class",
    "print_csv_format",
    "verify_results",
]
