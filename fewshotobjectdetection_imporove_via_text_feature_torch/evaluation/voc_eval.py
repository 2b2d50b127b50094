"""Pascal VOC AP evaluation with base/novel splits, counterpart of the JAX
package's ``evaluation/voc_eval.py`` (ref
defrcn/evaluation/pascal_voc_evaluation.py):
  * Matlab-convention IoU (+1 box widths), difficult GT neither TP nor FP,
    greedy per-detection matching in confidence order;
  * 11-point AP for VOC2007, area under the PR curve for 2012;
  * AP averaged over IoU 50..95 in steps of 5, with AP50/AP75, each also
    over the base and the novel classes (bAP*/nAP*);
  * predictions recorded with the +1 un-shift of the loader.
Detections accumulate in memory instead of the reference's per-class text
files; the arithmetic is the same (numpy, float64).
"""

from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict, defaultdict

import numpy as np

from ..data.catalog import MetadataCatalog
from ..data.meta_voc import _parse_voc_xml
from .evaluator import DatasetEvaluator

logger = logging.getLogger(__name__)


def voc_ap(rec, prec, use_07_metric=False):
    """AP from recall/precision curves (both conventions)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else np.max(prec[rec >= t])
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval_class(dets, gt_per_image, ovthresh=0.5, use_07_metric=False):
    """Evaluate one class.

    dets: list of (image_id, score, x1, y1, x2, y2), Matlab 1-based.
    gt_per_image: {image_id: {"bbox": (N, 4) raw-XML coordinates,
                              "difficult": (N,) bool}}.
    """
    npos = 0
    matched = {}
    for img, rec in gt_per_image.items():
        npos += int((~rec["difficult"]).sum())
        matched[img] = np.zeros(len(rec["difficult"]), bool)

    if not dets:
        return 0.0, 0.0, 0.0

    dets = sorted(dets, key=lambda d: -d[1])
    nd = len(dets)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d, (img, score, *bb) in enumerate(dets):
        rec = gt_per_image.get(img)
        bb = np.asarray(bb, float)
        ovmax, jmax = -np.inf, -1
        if rec is not None and len(rec["bbox"]):
            gt = rec["bbox"].astype(float)
            ixmin = np.maximum(gt[:, 0], bb[0])
            iymin = np.maximum(gt[:, 1], bb[1])
            ixmax = np.minimum(gt[:, 2], bb[2])
            iymax = np.minimum(gt[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inter = iw * ih
            union = (
                (bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                + (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0)
                - inter
            )
            overlaps = inter / union
            ovmax = overlaps.max()
            jmax = int(overlaps.argmax())

        if ovmax > ovthresh:
            if not rec["difficult"][jmax]:
                if not matched[img][jmax]:
                    tp[d] = 1.0
                    matched[img][jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    recall = tp / float(max(npos, 1))
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return recall, precision, voc_ap(recall, precision, use_07_metric)


class PascalVOCDetectionEvaluator(DatasetEvaluator):
    def __init__(self, dataset_name, output_dir=None):
        self._dataset_name = dataset_name
        meta = MetadataCatalog.get(dataset_name)
        self._anno_tpl = os.path.join(meta.dirname, "Annotations", "{}.xml")
        self._imageset = os.path.join(
            meta.dirname, "ImageSets", "Main", meta.split + ".txt"
        )
        self._class_names = meta.thing_classes
        self._base_classes = meta.get("base_classes")
        self._novel_classes = meta.get("novel_classes")
        self._is_2007 = meta.year == 2007
        self._output_dir = output_dir

    def reset(self):
        self._predictions = defaultdict(list)  # class id -> det tuples
        self._coco_json = []  # COCO-format dump

    def process_detections(self, image_ids, boxes, scores, classes, valid):
        """Accumulate one batch of padded detections (original-frame XYXY
        numpy arrays)."""
        for i, image_id in enumerate(image_ids):
            keep = np.asarray(valid[i])
            for box, score, cls in zip(
                np.asarray(boxes[i])[keep],
                np.asarray(scores[i])[keep],
                np.asarray(classes[i])[keep],
            ):
                x1, y1, x2, y2 = box
                # invert the loader's -1 shift
                self._predictions[int(cls)].append(
                    (image_id, float(score), x1 + 1.0, y1 + 1.0, x2, y2)
                )
                self._coco_json.append(
                    {
                        "image_id": image_id,
                        "category_id": int(cls),
                        "bbox": [float(x1), float(y1), float(x2 - x1),
                                 float(y2 - y1)],
                        "score": float(score),
                    }
                )

    def evaluate(self):
        with open(self._imageset) as f:
            imagenames = [ln.strip() for ln in f if ln.strip()]

        # per-class GT from the raw XML (no -1 shift, difficult kept)
        all_gt = {}
        for img in imagenames:
            _, _, objs = _parse_voc_xml(self._anno_tpl.format(img))
            for o in objs:  # undo _parse_voc_xml's loader shift
                o["bbox"] = [o["bbox"][0] + 1.0, o["bbox"][1] + 1.0,
                             o["bbox"][2], o["bbox"][3]]
            all_gt[img] = objs

        aps = defaultdict(list)
        aps_base = defaultdict(list)
        aps_novel = defaultdict(list)
        per_class_ap50 = {}
        for cls_id, cls_name in enumerate(self._class_names):
            gt_per_image = {}
            for img, objs in all_gt.items():
                sel = [o for o in objs if o["name"] == cls_name]
                gt_per_image[img] = {
                    "bbox": np.array([o["bbox"] for o in sel]).reshape(-1, 4),
                    "difficult": np.array(
                        [bool(o["difficult"]) for o in sel], bool
                    ),
                }
            dets = self._predictions.get(cls_id, [])
            for thresh in range(50, 100, 5):
                _, _, ap = voc_eval_class(
                    dets, gt_per_image, thresh / 100.0, self._is_2007
                )
                aps[thresh].append(ap * 100)
                if self._base_classes and cls_name in self._base_classes:
                    aps_base[thresh].append(ap * 100)
                if self._novel_classes and cls_name in self._novel_classes:
                    aps_novel[thresh].append(ap * 100)
            per_class_ap50[cls_name] = aps[50][-1]

        ret = OrderedDict()
        m_ap = {iou: np.mean(v) for iou, v in aps.items()}
        ret["bbox"] = {
            "AP": float(np.mean(list(m_ap.values()))),
            "AP50": float(m_ap[50]),
            "AP75": float(m_ap[75]),
        }
        if aps_base:
            m = {iou: np.mean(v) for iou, v in aps_base.items()}
            ret["bbox"].update(bAP=float(np.mean(list(m.values()))),
                               bAP50=float(m[50]), bAP75=float(m[75]))
        if aps_novel:
            m = {iou: np.mean(v) for iou, v in aps_novel.items()}
            ret["bbox"].update(nAP=float(np.mean(list(m.values()))),
                               nAP50=float(m[50]), nAP75=float(m[75]))
        logger.info("Per-class AP50: %s", per_class_ap50)
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            with open(os.path.join(self._output_dir,
                                   "coco_instances_results.json"), "w") as f:
                json.dump(self._coco_json, f)
        return ret
