"""Class metadata tables (public dataset constants), counterpart of the JAX
package's ``data/builtin_meta.py`` (ref defrcn/data/builtin_meta.py:163-254):
the COCO-80 category ids with the few-shot base/novel partition (novel = the
20 PASCAL-overlapping categories), and the PASCAL VOC few-shot splits, in
each of which the first 15 classes are the base classes and the last 5 the
novel ones."""

# 80 COCO "thing" categories as (dataset_id, name); ids are the official
# non-contiguous COCO ids.
COCO_THING_CATEGORIES = [
    (1, "person"), (2, "bicycle"), (3, "car"), (4, "motorcycle"),
    (5, "airplane"), (6, "bus"), (7, "train"), (8, "truck"), (9, "boat"),
    (10, "traffic light"), (11, "fire hydrant"), (13, "stop sign"),
    (14, "parking meter"), (15, "bench"), (16, "bird"), (17, "cat"),
    (18, "dog"), (19, "horse"), (20, "sheep"), (21, "cow"), (22, "elephant"),
    (23, "bear"), (24, "zebra"), (25, "giraffe"), (27, "backpack"),
    (28, "umbrella"), (31, "handbag"), (32, "tie"), (33, "suitcase"),
    (34, "frisbee"), (35, "skis"), (36, "snowboard"), (37, "sports ball"),
    (38, "kite"), (39, "baseball bat"), (40, "baseball glove"),
    (41, "skateboard"), (42, "surfboard"), (43, "tennis racket"),
    (44, "bottle"), (46, "wine glass"), (47, "cup"), (48, "fork"),
    (49, "knife"), (50, "spoon"), (51, "bowl"), (52, "banana"),
    (53, "apple"), (54, "sandwich"), (55, "orange"), (56, "broccoli"),
    (57, "carrot"), (58, "hot dog"), (59, "pizza"), (60, "donut"),
    (61, "cake"), (62, "chair"), (63, "couch"), (64, "potted plant"),
    (65, "bed"), (67, "dining table"), (70, "toilet"), (72, "tv"),
    (73, "laptop"), (74, "mouse"), (75, "remote"), (76, "keyboard"),
    (77, "cell phone"), (78, "microwave"), (79, "oven"), (80, "toaster"),
    (81, "sink"), (82, "refrigerator"), (84, "book"), (85, "clock"),
    (86, "vase"), (87, "scissors"), (88, "teddy bear"), (89, "hair drier"),
    (90, "toothbrush"),
]

# The 20 novel categories (PASCAL-VOC-overlapping subset of COCO).
COCO_NOVEL_IDS = [1, 2, 3, 4, 5, 6, 7, 9, 16, 17, 18, 19, 20, 21, 44, 62, 63,
                  64, 67, 72]

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


def _get_coco_instances_meta():
    thing_ids = [i for i, _ in COCO_THING_CATEGORIES]
    return {
        "thing_dataset_id_to_contiguous_id": {
            k: i for i, k in enumerate(thing_ids)},
        "thing_classes": [n for _, n in COCO_THING_CATEGORIES],
    }


def _get_coco_fewshot_instances_meta():
    ret = _get_coco_instances_meta()
    novel_set = set(COCO_NOVEL_IDS)
    novel = [(i, n) for i, n in COCO_THING_CATEGORIES if i in novel_set]
    base = [(i, n) for i, n in COCO_THING_CATEGORIES if i not in novel_set]
    ret["novel_dataset_id_to_contiguous_id"] = {
        k: i for i, (k, _) in enumerate(novel)}
    ret["novel_classes"] = [n for _, n in novel]
    ret["base_dataset_id_to_contiguous_id"] = {
        k: i for i, (k, _) in enumerate(base)}
    ret["base_classes"] = [n for _, n in base]
    return ret


def _get_voc_fewshot_instances_meta():
    return {
        "thing_classes": PASCAL_VOC_ALL_CATEGORIES,
        "novel_classes": PASCAL_VOC_NOVEL_CATEGORIES,
        "base_classes": PASCAL_VOC_BASE_CATEGORIES,
    }


def _get_builtin_metadata(dataset_name):
    if dataset_name == "coco":
        return _get_coco_instances_meta()
    if dataset_name == "coco_fewshot":
        return _get_coco_fewshot_instances_meta()
    if dataset_name == "voc_fewshot":
        return _get_voc_fewshot_instances_meta()
    raise KeyError(f"No built-in metadata for dataset {dataset_name}")
