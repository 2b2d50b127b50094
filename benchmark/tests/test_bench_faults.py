"""A run whose timed path is broken underneath comes out not correct: each
driver runs without the card check, on the CPU at a tiny size, with a
fault planted in the program for the run, once for each fault its cell
can have (one card: no exchange between cards).

On the card, at a cell's own size, the same faults give the readings that
the limits are set against (a short window, the check as a run makes it):

    python3 benchmark/tests/test_bench_faults.py --workload voc_r101.infer_b32 --fault altered_answer --seeds 1,2,3

(``--fault none``: the sound program's readings, seed after seed in one
process.)
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[2]),
                str(Path(__file__).resolve().parent)]

from harness import infer, train  # noqa: E402
from tiny import args, tiny_infer_cell  # noqa: E402


def _half_batch(monkeypatch):
    """The trunk computes the first half of the batch; the rest copies it."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.models \
        .backbone import ResNetC4

    forward = ResNetC4.forward

    def half(self, x):
        h = max(1, x.shape[0] // 2)
        feats = forward(self, x[:h])
        return {k: torch.cat([v, v[:x.shape[0] - h]]) for k, v in
                feats.items()}

    monkeypatch.setattr(ResNetC4, "forward", half)


def _altered_answer(monkeypatch):
    """Each detection's class is moved to the next class where the
    detections are made."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.models \
        import meta_arch

    inference = meta_arch.fast_rcnn_inference

    def altered(*a, **k):
        boxes, scores, classes, valid = inference(*a, **k)
        return boxes, scores, (classes + 1) % k["num_classes"], valid

    monkeypatch.setattr(meta_arch, "fast_rcnn_inference", altered)


def _altered_proposals(monkeypatch):
    """Each proposal is moved 16 pixels right and down where the RPN
    makes it."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.models \
        import meta_arch

    select = meta_arch.select_top_proposals

    def altered(*a, **k):
        p = select(*a, **k)
        shift = torch.where(p.valid[..., None], 16.0, 0.0)
        return type(p)(boxes=p.boxes + shift, objectness=p.objectness,
                       valid=p.valid)

    monkeypatch.setattr(meta_arch, "select_top_proposals", altered)


def _partial_proposals(monkeypatch):
    """Every fourth proposal is moved 16 pixels right and down where the
    RPN makes it."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.models \
        import meta_arch

    select = meta_arch.select_top_proposals

    def altered(*a, **k):
        p = select(*a, **k)
        every = torch.arange(p.boxes.shape[1], device=p.boxes.device) % 4 == 0
        shift = torch.where(p.valid[..., None] & every[None, :, None], 16.0,
                            0.0)
        return type(p)(boxes=p.boxes + shift, objectness=p.objectness,
                       valid=p.valid)

    monkeypatch.setattr(meta_arch, "select_top_proposals", altered)


def test_sound_tiny_run_is_correct():
    out = infer.run(args(), tiny_infer_cell(), torch.device("cpu"))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("plant", [_half_batch, _altered_answer,
                                   _altered_proposals, _partial_proposals],
                         ids=["half_batch", "altered_answer",
                              "altered_proposals", "partial_proposals"])
def test_planted_fault_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    out = infer.run(args(), tiny_infer_cell(), torch.device("cpu"))
    assert not out["correct"], out["checks"]


# -- the training cell ---------------------------------------------------
def _unchanged_state(monkeypatch):
    """The step returns its state unchanged: the optimizer never moves a
    parameter nor keeps a momentum buffer."""
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None:
                        None)


def _diverged_state(monkeypatch):
    """From its fifth step on the optimizer writes NaN into every
    parameter, as a run whose weights diverged (the checked steps, the
    first three, stay sound)."""
    step = torch.optim.SGD.step
    calls = [0]

    def diverging(self, closure=None):
        calls[0] += 1
        out = step(self, closure)
        if calls[0] >= 5:
            with torch.no_grad():
                for group in self.param_groups:
                    for p in group["params"]:
                        p.fill_(float("nan"))
        return out

    monkeypatch.setattr(torch.optim.SGD, "step", diverging)


def _half_batch_mean(monkeypatch):
    """The step's losses come from the first half of the batch alone (the
    mean over the rest)."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.models \
        .meta_arch import GeneralizedRCNN
    from fewshotobjectdetection_imporove_via_text_feature_torch.structures \
        import GTInstances, ImageBatch

    forward = GeneralizedRCNN.forward_train

    def half(self, images, gt, *a, **k):
        h = max(1, images.image.shape[0] // 2)
        images = ImageBatch(images.image[:h], images.hw[:h],
                            images.orig_hw[:h])
        gt = GTInstances(gt.boxes[:h], gt.classes[:h], gt.valid[:h])
        return forward(self, images, gt, *a, **k)

    monkeypatch.setattr(GeneralizedRCNN, "forward_train", half)


def _altered_loss(monkeypatch):
    """The classification loss is doubled where it is made."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.models \
        import meta_arch

    losses = meta_arch.fast_rcnn_losses

    def altered(*a, **k):
        out = losses(*a, **k)
        out["loss_cls"] = 2.0 * out["loss_cls"]
        return out

    monkeypatch.setattr(meta_arch, "fast_rcnn_losses", altered)


def _altered_labels(monkeypatch):
    """Each sampled foreground ROI's class is moved to the next class where
    the ROIs are labelled."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.models \
        import meta_arch

    label = meta_arch.label_and_sample_proposals

    def altered(*a, **k):
        out = label(*a, **k)
        c, num = out["gt_classes"], a[4]
        out["gt_classes"] = torch.where(c < num, (c + 1) % num, c)
        return out

    monkeypatch.setattr(meta_arch, "label_and_sample_proposals", altered)


def test_sound_tiny_training_run_is_correct():
    from tiny import tiny_train_cell

    out = train.run(args(seconds=0.5), tiny_train_cell(dtype="float32"),
                    torch.device("cpu"))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize(
    "plant", [_unchanged_state, _half_batch_mean, _altered_loss,
              _altered_labels, _altered_proposals, _diverged_state],
    ids=["unchanged_state", "half_batch_mean", "altered_loss",
         "altered_labels", "altered_proposals", "diverged_state"])
def test_planted_training_fault_is_not_correct(monkeypatch, plant):
    from tiny import tiny_train_cell

    plant(monkeypatch)
    out = train.run(args(seconds=0.5), tiny_train_cell(dtype="float32"),
                    torch.device("cpu"))
    assert not out["correct"], out["checks"]


FAULTS = {"half_batch": _half_batch, "altered_answer": _altered_answer,
          "altered_proposals": _altered_proposals,
          "partial_proposals": _partial_proposals,
          "altered_labels": _altered_labels,
          "diverged_state": _diverged_state,
          "none": lambda mp: None,
          "unchanged_state": _unchanged_state,
          "half_batch_mean": _half_batch_mean, "altered_loss": _altered_loss}


def main():
    import argparse
    import json
    import types

    from harness import core

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args()
    core.require_cards(1)
    cell = core.find_cell(core.load_spec(pending=True), a.workload)
    driver = train if cell["traffic"]["driver"] == "train" else infer
    for seed in (int(x) for x in a.seeds.split(",")):
        with pytest.MonkeyPatch.context() as mp:
            FAULTS[a.fault](mp)
            out = driver.run(types.SimpleNamespace(
                seed=seed, seconds=a.seconds, trace=0), cell,
                torch.device("cuda", 0))
        print(json.dumps({"seed": seed, "fault": a.fault,
                          "correct": out["correct"],
                          "readings": {n: c["value"] for n, c in
                                       out["checks"].items()}}), flush=True)


if __name__ == "__main__":
    main()
