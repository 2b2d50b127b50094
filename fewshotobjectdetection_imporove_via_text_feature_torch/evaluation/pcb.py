"""Prototypical Calibration Block (PCB), counterpart of the JAX package's
``evaluation/pcb.py`` (ref defrcn/evaluation/calibration_layer.py:17-151):

  * a separate ImageNet ResNet-101 (torchvision weights) turns each box of
    an ORIGINAL-size image into a 1000-d vector: the res5 map at 1/32,
    ROIAlignV2 1x1 with adaptive sampling (``ops.roi_align``; on the card
    the hand-written ROIAlign forward kernel), then ``fc``;
  * the class prototypes are the mean vector of each class over the boxes
    of the k-shot support set (cfg.DATASETS.TRAIN[0]), built once;
  * at test time a detection with PCB_LOWER < score <= PCB_UPPER gets
    score <- alpha * score + (1 - alpha) * cos(vector, prototype[class]);
    excluded classes (the base classes of a ``*test_all*`` set) and classes
    with no prototype keep their scores.

Images are padded to a multiple of 64 on each side (``_bucket``); that
padding is part of the numbers (the res5 size, ROIAlign's adaptive cap and
border clamps depend on it). Images sharing a padded size go through the
network as one batch, with one ROIAlign call for the group. The network
runs in float32 with TF32 off, as the JAX package runs it in float32
(PyTorch would otherwise let cuDNN round float32 convolutions to TF32).
"""

from __future__ import annotations

import contextlib
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..checkpoint.torch_import import apply_weight_dict, load_torch_state
from ..data.loader import get_detection_dataset_dicts
from ..data.mapper import _open_oriented
from ..engine.predictor import resolve_device
from ..ops.roi_align import roi_align
from .archs import TorchvisionResNet, init_tv_weights

logger = logging.getLogger(__name__)

# torchvision ImageNet statistics (RGB)
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)
# the COCO contiguous ids of the 60 base classes, which a *test_all* set
# does not rescore (ref calibration_layer.py:126-139)
_COCO_BASE = [7, 9, 10, 11, 12, 13, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
              30, 31, 32, 33, 34, 35, 36, 37, 38, 40, 41, 42, 43, 44, 45, 46,
              47, 48, 49, 50, 51, 52, 53, 54, 55, 59, 61, 63, 64, 65, 66, 67,
              68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79]
SUPPORT_CHUNK = 16  # support images a batch when the prototypes are built


def _bucket(h, w):
    up = lambda v: int(np.ceil(v / 64.0) * 64)
    return up(h), up(w)


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class PrototypicalCalibrationBlock:
    """Built from cfg (TEST.PCB_*, DATASETS.TRAIN[0] for the prototypes,
    DATASETS.TEST for the image-id map) on ``cfg.MODEL.DEVICE`` unless
    ``device`` is given. ``prototype_seconds`` is the prototype build's
    time."""

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.alpha = cfg.TEST.PCB_ALPHA
        self.upper = cfg.TEST.PCB_UPPER
        self.lower = cfg.TEST.PCB_LOWER
        # ref calibration_layer.py:34-37: 'resnet' or NotImplementedError
        if cfg.TEST.PCB_MODELTYPE != "resnet":
            raise NotImplementedError(
                f"TEST.PCB_MODELTYPE {cfg.TEST.PCB_MODELTYPE!r}: only "
                "'resnet' exists (the reference raises the same way)"
            )
        self.device = resolve_device(cfg, device)
        self.model = TorchvisionResNet(depth=101)
        self._load_params(cfg.TEST.PCB_MODELPATH)
        self.model.to(self.device).eval()

        t0 = time.perf_counter()
        self.prototypes = self.build_prototypes()
        self.prototype_seconds = time.perf_counter() - t0
        self.exclude_cls = self.clsid_filter()
        # test-set image_id -> file, for callers that pass no file names;
        # ids can collide across DATASETS.TEST entries (VOC 2007/2012), and
        # a colliding id fails its lookup instead of reading another set's
        # pixels
        self._files: Dict = {}
        self._ambiguous = set()
        for name in cfg.DATASETS.TEST:
            for r in get_detection_dataset_dicts([name], filter_empty=False):
                old = self._files.setdefault(r["image_id"], r["file_name"])
                if old != r["file_name"]:
                    self._ambiguous.add(r["image_id"])

    def _load_params(self, path):
        init_tv_weights(self.model, torch.Generator().manual_seed(0))
        if path:
            # a missing file fails here, as the reference's torch.load does:
            # rescoring with random prototypes corrupts every reported AP
            matched, skipped = apply_weight_dict(
                self.model, load_torch_state(path), lambda name: name)
            logger.info("PCB: loaded %d tensors from %s (%d unmatched)",
                        matched, path, len(skipped))
        else:
            logger.warning(
                "TEST.PCB_MODELPATH is empty: PCB will rescore with a "
                "RANDOM ResNet (only meaningful in tests; point it at the "
                "torchvision R-101 ImageNet weights for real evaluation)"
            )

    @torch.inference_mode()
    def _extract(self, images, boxes, hw):
        """images (G, bh, bw, 3) uint8, boxes (G, N, 4) in original
        coordinates, hw (G, 2) valid sizes -> (G, N, 1000) float32."""
        dev = self.device
        x = images.to(dev).permute(0, 3, 1, 2).float() / 255.0
        mean = torch.from_numpy(_MEAN).to(dev)[:, None, None]
        std = torch.from_numpy(_STD).to(dev)[:, None, None]
        x = (x - mean) / std
        # zero the pad region AFTER normalization: the reference runs each
        # image unpadded, and its conv padding is zero in normalized space
        hw = hw.to(dev)
        bh, bw = x.shape[2:]
        rows = torch.arange(bh, device=dev)[None, :, None] < hw[:, 0, None,
                                                               None]
        cols = torch.arange(bw, device=dev)[None, None, :] < hw[:, 1, None,
                                                               None]
        x = x * (rows & cols)[:, None].to(x.dtype)
        with _no_tf32():
            _, feat = self.model(x)
        # ROIAlignV2 1x1 at 1/32 with sampling_ratio 0 (the reference's
        # pooler, calibration_layer.py:27): a dense average over each box
        pooled = roi_align(feat.float(), boxes.to(dev), 1, 1.0 / 32.0, 0)
        fc = self.model.fc
        return F.linear(pooled[..., 0, 0], fc.weight, fc.bias)

    @staticmethod
    def _load_padded(file_name):
        # cv2.imread (the reference's loader, calibration_layer.py:108)
        # applies EXIF orientation; so does _open_oriented
        img, _ = _open_oriented(file_name)
        img = np.asarray(img.convert("RGB"), np.uint8)
        h, w = img.shape[:2]
        bh, bw = _bucket(h, w)
        padded = np.zeros((bh, bw, 3), np.uint8)
        padded[:h, :w] = img
        return padded, (h, w)

    def _roi_features_batch(self, files, boxes_list):
        """files: [str] * K; boxes_list: [(n_i, 4) original coordinates] *
        K -> [(n_i, 1000)] * K. Images are decoded in threads and grouped
        by padded size; each group pads its boxes to its largest count."""
        with ThreadPoolExecutor(8) as pool:
            loaded = list(pool.map(self._load_padded, files))
        out = [None] * len(files)
        groups: Dict = {}
        for i, (padded, _) in enumerate(loaded):
            groups.setdefault(padded.shape[:2], []).append(i)
        for (bh, bw), idxs in groups.items():
            n = max(max(len(boxes_list[i]) for i in idxs), 1)
            imgs = np.stack([loaded[i][0] for i in idxs])
            pboxes = np.zeros((len(idxs), n, 4), np.float32)
            hws = np.zeros((len(idxs), 2), np.int32)
            for j, i in enumerate(idxs):
                pboxes[j, :len(boxes_list[i])] = boxes_list[i]
                hws[j] = loaded[i][1]
            feats = self._extract(torch.from_numpy(imgs),
                                  torch.from_numpy(pboxes),
                                  torch.from_numpy(hws)).cpu().numpy()
            for j, i in enumerate(idxs):
                out[i] = feats[j, :len(boxes_list[i])]
        return out

    def build_prototypes(self):
        name = self.cfg.DATASETS.TRAIN[0]
        dicts = get_detection_dataset_dicts([name], filter_empty=True)
        files, boxes_list, labels = [], [], []
        for rec in dicts:
            annos = rec["annotations"]
            boxes = np.array([a["bbox"] for a in annos],
                             np.float32).reshape(-1, 4)
            if not len(boxes):
                continue
            files.append(rec["file_name"])
            boxes_list.append(boxes)
            labels.extend(int(a["category_id"]) for a in annos)
        feats = []
        for start in range(0, len(files), SUPPORT_CHUNK):
            feats.extend(self._roi_features_batch(
                files[start:start + SUPPORT_CHUNK],
                boxes_list[start:start + SUPPORT_CHUNK]))
        feats = np.concatenate(feats, axis=0)
        labels = np.asarray(labels)
        protos = {int(c): feats[labels == c].mean(axis=0)
                  for c in np.unique(labels)}
        logger.info("PCB: built %d class prototypes from %s", len(protos),
                    name)
        return protos

    def clsid_filter(self):
        dsname = self.cfg.DATASETS.TEST[0]
        if "test_all" in dsname:
            if "coco" in dsname:
                return list(_COCO_BASE)
            if "voc" in dsname:
                return list(range(0, 15))
            raise NotImplementedError(dsname)
        return []

    def _apply_cos(self, feats, idx, classes, scores):
        for j, i in enumerate(idx):
            c = int(classes[i])
            if c in self.exclude_cls or c not in self.prototypes:
                continue
            p = self.prototypes[c]
            f = feats[j]
            cos = float(np.dot(f, p) / max(
                np.linalg.norm(f) * np.linalg.norm(p), 1e-12))
            scores[i] = scores[i] * self.alpha + cos * (1 - self.alpha)
        return scores

    def calibrate_image(self, image_id, boxes, scores, classes, valid):
        """One image's scores, rescored (numpy)."""
        det = self.execute_calibration([image_id], {
            "boxes": boxes[None], "scores": scores[None],
            "classes": classes[None], "valid": valid[None]})
        return det["scores"][0]

    def _resolve_file(self, image_id):
        if image_id in self._ambiguous:
            raise ValueError(
                f"image_id {image_id!r} exists in multiple DATASETS.TEST "
                "entries with different files; pass file_names to "
                "execute_calibration (the evaluator's batch meta carries "
                "them)"
            )
        return self._files.get(image_id)

    def execute_calibration(self, image_ids, det_np, file_names=None):
        """det_np: boxes/scores/classes/valid, (B, D, ...) numpy in ORIGINAL
        image coordinates; returns it with the scores rescored in place.
        ``file_names`` (parallel to image_ids, the batch's own) name the
        images; without them the ids resolve through DATASETS.TEST. All the
        batch's images go through the network together."""
        files, boxes_list, work = [], [], []
        for i, image_id in enumerate(image_ids):
            file_name = (file_names[i] if file_names is not None
                         and file_names[i] else self._resolve_file(image_id))
            if file_name is None:
                continue
            scores = det_np["scores"][i]
            sel = (det_np["valid"][i] & (scores > self.lower)
                   & (scores <= self.upper))
            idx = np.nonzero(sel)[0]
            if len(idx) == 0:
                continue
            files.append(file_name)
            boxes_list.append(det_np["boxes"][i][idx])
            work.append((i, idx))
        if files:
            feats_list = self._roi_features_batch(files, boxes_list)
            for feats, (i, idx) in zip(feats_list, work):
                det_np["scores"][i] = self._apply_cos(
                    feats, idx, det_np["classes"][i], det_np["scores"][i])
        return det_np
