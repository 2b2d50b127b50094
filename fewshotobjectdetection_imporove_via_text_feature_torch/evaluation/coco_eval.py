"""COCO-style AP evaluation in pure numpy (no pycocotools), counterpart of
the JAX package's ``evaluation/coco_eval.py``.

Parity with defrcn/evaluation/coco_evaluation.py:23-291, which runs COCOeval
over all classes and over the base/novel catId subsets to report
AP/AP50/AP75/APs/APm/APl plus bAP*/nAP*. This module re-implements the
COCOeval matching/accumulation algorithm (iouThrs 0.50:0.05:0.95, 101-point
interpolated precision, area ranges, maxDets=100, crowd-ignore semantics)
directly over dataset dicts + padded detections.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..data.catalog import MetadataCatalog
from .evaluator import DatasetEvaluator

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = 100


def _iou_xyxy(det, gt, iscrowd):
    """IoU matrix (D, G); for crowd GT the denominator is det area."""
    d_area = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    g_area = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = d_area[:, None] + g_area[None, :] - inter
    union = np.where(iscrowd[None, :], d_area[:, None], union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _match_image(det_boxes, det_scores, gt_boxes, gt_crowd, gt_ignore):
    """COCOeval per-image matching for all IoU thresholds.

    Returns (dt_matched_gt_ignore (T, D) bool, dt_matched (T, D) bool,
    order) with detections pre-sorted by score desc.
    """
    order = np.argsort(-det_scores, kind="stable")[:MAX_DETS]
    det_boxes = det_boxes[order]
    d, g = len(det_boxes), len(gt_boxes)
    t = len(IOU_THRS)
    dt_ignore = np.zeros((t, d), bool)
    dt_match = np.zeros((t, d), bool)
    if g == 0 or d == 0:
        return dt_ignore, dt_match, order

    # gt sorted: non-ignored first (COCOeval sorts by _ignore)
    gt_order = np.argsort(gt_ignore, kind="stable")
    gt_boxes = gt_boxes[gt_order]
    gt_crowd = gt_crowd[gt_order]
    gt_ignore = gt_ignore[gt_order]

    ious = _iou_xyxy(det_boxes, gt_boxes, gt_crowd)
    for ti, thr in enumerate(IOU_THRS):
        gt_used = np.zeros(g, bool)
        for di in range(d):
            best_iou = min(thr, 1 - 1e-10)
            best_g = -1
            for gi in range(g):
                if gt_used[gi] and not gt_crowd[gi]:
                    continue
                # stop at ignored gt if a real match was already found
                if best_g > -1 and not gt_ignore[best_g] and gt_ignore[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best_g = gi
            if best_g >= 0:
                gt_used[best_g] = True
                dt_match[ti, di] = True
                dt_ignore[ti, di] = gt_ignore[best_g]
    return dt_ignore, dt_match, order


def evaluate_coco_detections(gt_by_image, dets_by_image, class_ids):
    """Compute COCO metrics over the given contiguous class ids.

    gt_by_image: {image_id: list of dicts(bbox XYXY, category_id, iscrowd)}
    dets_by_image: {image_id: (boxes (N,4), scores (N,), classes (N,))}
    """
    metrics = {}
    # precision[t, r, k, a] like COCOeval
    precision = np.full(
        (len(IOU_THRS), len(REC_THRS), len(class_ids), len(AREA_RNGS)), -1.0
    )

    for ki, cls in enumerate(class_ids):
        # gather per image
        per_img = {}
        for img, anns in gt_by_image.items():
            sel = [a for a in anns if a["category_id"] == cls]
            boxes = np.array([a["bbox"] for a in sel], float).reshape(-1, 4)
            crowd = np.array([a.get("iscrowd", 0) for a in sel], bool)
            # COCOeval area-range ignore uses the annotation 'area' field
            # (segmentation area on real COCO); fall back to bbox area,
            # which is what d2's convert_to_coco_json writes for box-only
            # datasets (VOC routed through the COCO evaluator).
            areas = np.array(
                [
                    a.get(
                        "area",
                        (a["bbox"][2] - a["bbox"][0])
                        * (a["bbox"][3] - a["bbox"][1]),
                    )
                    for a in sel
                ],
                float,
            )
            per_img[img] = (boxes, crowd, areas)

        det_img = {}
        for img, (boxes, scores, classes) in dets_by_image.items():
            m = classes == cls
            det_img[img] = (boxes[m], scores[m])

        for ai, (aname, (lo, hi)) in enumerate(AREA_RNGS.items()):
            scores_all, match_all, ignore_all = [], [], []
            npos = 0
            for img in gt_by_image:
                gt_boxes, gt_crowd, areas = per_img.get(
                    img,
                    (np.zeros((0, 4)), np.zeros(0, bool), np.zeros(0)),
                )
                gt_ignore = gt_crowd | (areas < lo) | (areas > hi)
                npos += int((~gt_ignore).sum())
                db, ds = det_img.get(img, (np.zeros((0, 4)), np.zeros(0)))
                dt_ig, dt_m, order = _match_image(
                    db, ds, gt_boxes, gt_crowd, gt_ignore
                )
                d_areas = (db[order][:, 2] - db[order][:, 0]) * (
                    db[order][:, 3] - db[order][:, 1]
                )
                out_rng = (d_areas < lo) | (d_areas > hi)
                # unmatched dets outside the range are ignored too
                dt_ig = dt_ig | (~dt_m & out_rng[None, :])
                scores_all.append(ds[order])
                match_all.append(dt_m)
                ignore_all.append(dt_ig)

            if npos == 0:
                continue
            scores_cat = np.concatenate(scores_all)
            match_cat = np.concatenate(match_all, axis=1)
            ignore_cat = np.concatenate(ignore_all, axis=1)
            order = np.argsort(-scores_cat, kind="stable")
            match_cat = match_cat[:, order]
            ignore_cat = ignore_cat[:, order]

            for ti in range(len(IOU_THRS)):
                keep = ~ignore_cat[ti]
                tps = np.cumsum(match_cat[ti][keep])
                fps = np.cumsum(~match_cat[ti][keep])
                rc = tps / npos
                pr = tps / np.maximum(tps + fps, 1e-12)
                # precision envelope
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                inds = np.searchsorted(rc, REC_THRS, side="left")
                q = np.zeros(len(REC_THRS))
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precision[ti, :, ki, ai] = q

    def _summarize(iou=None, area="all"):
        ai = list(AREA_RNGS).index(area)
        p = precision[:, :, :, ai]
        if iou is not None:
            ti = int(np.argwhere(np.isclose(IOU_THRS, iou))[0, 0])
            p = p[ti : ti + 1]
        valid = p[p > -1]
        return float(np.mean(valid) * 100) if valid.size else float("nan")

    metrics["AP"] = _summarize()
    metrics["AP50"] = _summarize(iou=0.5)
    metrics["AP75"] = _summarize(iou=0.75)
    metrics["APs"] = _summarize(area="small")
    metrics["APm"] = _summarize(area="medium")
    metrics["APl"] = _summarize(area="large")
    return metrics


class COCOEvaluator(DatasetEvaluator):
    """Accumulates padded detections; reports all/base/novel metric blocks
    like the reference COCOEvaluator (coco_evaluation.py:132-194)."""

    def __init__(self, dataset_name, output_dir=None, dataset_dicts=None):
        from ..data.loader import get_detection_dataset_dicts

        self._meta = MetadataCatalog.get(dataset_name)
        if dataset_dicts is None:
            dataset_dicts = get_detection_dataset_dicts(
                [dataset_name], filter_empty=False
            )
        self._gt_by_image = {
            r["image_id"]: r.get("annotations", []) for r in dataset_dicts
        }
        self._output_dir = output_dir

    def reset(self):
        self._dets = {}

    def process_detections(self, image_ids, boxes, scores, classes, valid):
        for i, image_id in enumerate(image_ids):
            keep = np.asarray(valid[i])
            self._dets[image_id] = (
                np.asarray(boxes[i])[keep],
                np.asarray(scores[i])[keep],
                np.asarray(classes[i])[keep].astype(int),
            )

    def evaluate(self):
        classes = list(range(len(self._meta.thing_classes)))
        res = evaluate_coco_detections(
            self._gt_by_image, self._dets, classes
        )
        out = OrderedDict()
        out["bbox"] = dict(res)

        if self._output_dir:
            # COCO-format dump like the reference COCOEvaluator
            # (coco_evaluation.py:89-117, via d2 instances_to_coco_json):
            # XYWH boxes, category_id mapped back to DATASET ids.
            import json
            import os

            id_map = self._meta.get("thing_dataset_id_to_contiguous_id")
            rev = {v: k for k, v in id_map.items()} if id_map else None
            dump = []
            for image_id, (boxes, scores, cls) in self._dets.items():
                for b, s, c in zip(boxes, scores, cls):
                    x1, y1, x2, y2 = (float(v) for v in b)
                    dump.append(
                        {
                            "image_id": image_id,
                            "category_id": (
                                rev[int(c)] if rev is not None else int(c)
                            ),
                            "bbox": [x1, y1, x2 - x1, y2 - y1],
                            "score": float(s),
                        }
                    )
            os.makedirs(self._output_dir, exist_ok=True)
            with open(
                os.path.join(
                    self._output_dir, "coco_instances_results.json"
                ),
                "w",
            ) as f:
                json.dump(dump, f)

        # base/novel splits when the dataset is an "all" few-shot split
        name_to_id = {
            n: i for i, n in enumerate(self._meta.thing_classes)
        }
        for prefix, key in (("b", "base_classes"), ("n", "novel_classes")):
            subset = self._meta.get(key)
            if not subset:
                continue
            ids = [name_to_id[n] for n in subset if n in name_to_id]
            if not ids or len(ids) == len(classes):
                continue
            sub = evaluate_coco_detections(self._gt_by_image, self._dets, ids)
            out["bbox"].update({prefix + k: v for k, v in sub.items()})
        return out
