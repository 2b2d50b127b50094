"""Dataset name -> class-name list, counterpart of the JAX package's
``utils/class_name.py`` (ref defrcn/utils/class_name.py:4-29); reads this
package's own ``data/builtin_meta.py`` and ``data/catalog.py``."""

from __future__ import annotations

import re

from ..data.builtin_meta import (
    PASCAL_VOC_ALL_CATEGORIES,
    PASCAL_VOC_BASE_CATEGORIES,
    PASCAL_VOC_NOVEL_CATEGORIES,
    _get_coco_fewshot_instances_meta,
)


def _voc_split_id(dataset: str, kind: str) -> int:
    """The split id of a VOC dataset name: the digit of its ``{kind}{N}``
    token wherever it sits (voc_2007_trainval_all1,
    ..._all1_2shot_seed0, a custom ..._all1_t_train); else the reference's
    positional parse (the last token, or the third from last when the name
    ends in a seed)."""
    for tok in dataset.split("_"):
        m = re.fullmatch(rf"{kind}(\d)", tok)
        if m:
            return int(m.group(1))
    toks = dataset.split("_")
    if toks[-1].startswith("seed"):
        return int(toks[-3][-1])
    return int(toks[-1][-1])


def get_class_name(cfg):
    """The class names of ``cfg.DATASETS.TRAIN[0]``: VOC base / novel / all
    of its split, COCO base / novel / all, else the catalog's
    ``thing_classes``; raises ValueError when none resolves."""
    dataset = cfg.DATASETS.TRAIN[0]
    classes = None
    try:
        if "voc" in dataset:
            if "base" in dataset:
                classes = PASCAL_VOC_BASE_CATEGORIES[
                    _voc_split_id(dataset, "base")]
            if "novel" in dataset:
                classes = PASCAL_VOC_NOVEL_CATEGORIES[
                    _voc_split_id(dataset, "novel")]
            if "all" in dataset:
                classes = PASCAL_VOC_ALL_CATEGORIES[
                    _voc_split_id(dataset, "all")]
        if "coco" in dataset:
            ret = _get_coco_fewshot_instances_meta()
            if "base" in dataset:
                classes = ret["base_classes"]
            if "novel" in dataset:
                classes = ret["novel_classes"]
            if "all" in dataset:
                classes = ret["thing_classes"]
    except (ValueError, KeyError, IndexError):
        classes = None
    if classes is None:
        # a name the grammar cannot parse (a custom registration): the
        # catalog knows its class list
        try:
            from ..data.catalog import MetadataCatalog

            classes = list(MetadataCatalog.get(dataset).thing_classes)
        except Exception:
            classes = None
    if classes is None:
        raise ValueError(f"cannot resolve class names for {dataset!r}")
    return classes


def get_class_name_test(cfg):
    """All 20 VOC classes of the split in the last token of
    ``cfg.DATASETS.TRAIN[0]`` (ref class_name.py:26-29, the reference's
    parse: right for names without a seed, such as voc_2007_test_all1)."""
    dataset = cfg.DATASETS.TRAIN[0]
    return PASCAL_VOC_ALL_CATEGORIES[int(dataset.split("_")[-1][-1])]


# GloVe words of the VOC class tokens (ref attentive_modules.py:352)
VOC_GLOVE_NAME_MAP = {
    "aeroplane": "aeroplane", "bicycle": "bicycle", "boat": "boat",
    "bottle": "bottle", "car": "car", "cat": "cat", "chair": "chair",
    "diningtable": "dining table", "dog": "dog", "horse": "horse",
    "person": "person", "pottedplant": "potted plant", "sheep": "sheep",
    "train": "train", "tvmonitor": "tv", "bird": "bird", "bus": "bus",
    "cow": "cow", "motorbike": "motorbike", "sofa": "sofa",
}
