"""PASCAL VOC few-shot class splits (public dataset constants), counterpart
of the VOC part of the JAX package's ``data/builtin_meta.py``
(ref defrcn/data/builtin_meta.py:163-254). In every split the first 15
classes are the base classes and the last 5 the novel ones. The COCO tables
come with the COCO slice (ROADMAP.md Queue 1 item 12)."""

PASCAL_VOC_ALL_CATEGORIES = {
    1: ["aeroplane", "bicycle", "boat", "bottle", "car",
        "cat", "chair", "diningtable", "dog", "horse",
        "person", "pottedplant", "sheep", "train", "tvmonitor",
        "bird", "bus", "cow", "motorbike", "sofa"],
    2: ["bicycle", "bird", "boat", "bus", "car",
        "cat", "chair", "diningtable", "dog", "motorbike",
        "person", "pottedplant", "sheep", "train", "tvmonitor",
        "aeroplane", "bottle", "cow", "horse", "sofa"],
    3: ["aeroplane", "bicycle", "bird", "bottle", "bus",
        "car", "chair", "cow", "diningtable", "dog",
        "horse", "person", "pottedplant", "train", "tvmonitor",
        "boat", "cat", "motorbike", "sheep", "sofa"],
}

PASCAL_VOC_NOVEL_CATEGORIES = {
    1: ["bird", "bus", "cow", "motorbike", "sofa"],
    2: ["aeroplane", "bottle", "cow", "horse", "sofa"],
    3: ["boat", "cat", "motorbike", "sheep", "sofa"],
}

PASCAL_VOC_BASE_CATEGORIES = {
    1: ["aeroplane", "bicycle", "boat", "bottle", "car",
        "cat", "chair", "diningtable", "dog", "horse",
        "person", "pottedplant", "sheep", "train", "tvmonitor"],
    2: ["bicycle", "bird", "boat", "bus", "car",
        "cat", "chair", "diningtable", "dog", "motorbike",
        "person", "pottedplant", "sheep", "train", "tvmonitor"],
    3: ["aeroplane", "bicycle", "bird", "bottle", "bus",
        "car", "chair", "cow", "diningtable", "dog",
        "horse", "person", "pottedplant", "train", "tvmonitor"],
}


def _get_voc_fewshot_instances_meta():
    return {
        "thing_classes": PASCAL_VOC_ALL_CATEGORIES,
        "novel_classes": PASCAL_VOC_NOVEL_CATEGORIES,
        "base_classes": PASCAL_VOC_BASE_CATEGORIES,
    }


def _get_builtin_metadata(dataset_name):
    if dataset_name == "voc_fewshot":
        return _get_voc_fewshot_instances_meta()
    if dataset_name.startswith("coco"):
        raise NotImplementedError(
            f"metadata {dataset_name!r}: COCO is not ported to the PyTorch "
            "package yet: ROADMAP.md Queue 1 item 12 (COCO)"
        )
    raise KeyError(f"No built-in metadata for dataset {dataset_name}")
