"""Hooks on the program's modules that copy what the timed path produces at
each stage boundary, for the batches the benchmark chose to check, and an
evaluator that keeps the detections and counts the images."""

from __future__ import annotations

import numpy as np


class StageCapture:
    """Forward hooks on the backbone, the RPN head and the ROI heads.
    While ``armed`` holds a key, each hook copies its stage's tensors into
    ``store[key]``; otherwise the hooks return at once."""

    def __init__(self, model):
        self.armed = None
        self.store = {}
        self.handles = [
            model.backbone.register_forward_hook(self._backbone),
            model.proposal_generator.rpn_head.register_forward_hook(
                self._rpn),
            model.roi_heads.register_forward_pre_hook(self._roi_in),
            model.roi_heads.register_forward_hook(self._roi_out),
        ]

    def _put(self, **kv):
        if self.armed is not None:
            self.store.setdefault(self.armed, {}).update(
                {k: v.detach().clone() for k, v in kv.items()})

    def _backbone(self, mod, args, out):
        self._put(res4=out["res4"])

    def _rpn(self, mod, args, out):
        self._put(rpn_logits=out[0], rpn_deltas=out[1])

    def _roi_in(self, mod, args):
        self._put(proposals=args[1])

    def _roi_out(self, mod, args, out):
        self._put(roi_scores=out[0], roi_deltas=out[1])

    def remove(self):
        for h in self.handles:
            h.remove()


def make_recorder(keep_ids=()):
    """An evaluator of the program's interface that counts the images it
    receives and keeps the valid detections of the images in
    ``keep_ids`` (their latest)."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation \
        .evaluator import DatasetEvaluator

    keep = set(keep_ids)

    class Recorder(DatasetEvaluator):
        def __init__(self):
            self.images = 0
            self.kept = {}

        def reset(self):
            pass

        def process_detections(self, image_ids, boxes, scores, classes,
                               valid):
            self.images += len(image_ids)
            for i, iid in enumerate(image_ids):
                if iid in keep:
                    v = np.asarray(valid[i], bool)
                    self.kept[iid] = (np.asarray(boxes[i])[v],
                                      np.asarray(scores[i])[v],
                                      np.asarray(classes[i])[v])

        def evaluate(self):
            return {}

    return Recorder()
