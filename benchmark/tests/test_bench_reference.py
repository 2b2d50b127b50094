"""The float32 references hold the program at a tiny size on the CPU: the
detector's stages, captured from the program's own evaluation of a batch,
agree with the reference to float32 round-off, and so do the text
student's checked training steps (losses, first gradients, parameter
changes); the bfloat16 evaluation stays inside the cell's limits. (The
bfloat16 training steps are held on the card only: at tiny widths and
full depth their losses run to the hundreds and three steps part.)"""

from __future__ import annotations

import torch

from harness import infer, train
from tiny import args, tiny_infer_cell, tiny_train_cell


def _values(out):
    return {n: c["value"] for n, c in out["checks"].items()}


def test_detector_reference_matches_the_float32_program():
    cell = tiny_infer_cell()
    cell["config"]["compute_dtype"] = "float32"
    v = _values(infer.run(args(), cell, torch.device("cpu")))
    assert v["backbone_rel"] < 1e-5 and v["rpn_head_rel"] < 1e-5, v
    assert v["roi_head_rel"] < 1e-5, v
    assert v["proposals_missed"] == 0 and v["detections_missed"] == 0, v
    assert v["batches_checked"] == 2 and v["images_lost"] == 0, v


def test_student_reference_matches_the_float32_program():
    cell = tiny_train_cell(dtype="float32")
    v = _values(train.run(args(seconds=0.3), cell, torch.device("cpu")))
    assert v["loss_gap"] < 1e-5, v
    assert v["grad_gap"] < 1e-4 and v["change_gap"] < 1e-4, v


def test_bfloat16_evaluation_is_correct_at_tiny_size():
    out = infer.run(args(seconds=0.3), tiny_infer_cell(),
                    torch.device("cpu"))
    assert out["correct"], out["checks"]
