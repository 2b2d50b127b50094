"""The two-stage teacher -> student distillation overfit check on the port.

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.overfit_distill_check \\
        [--production] [--device cpu]

Counterpart of the repository's ``tools/overfit_distill_check.py``, on the
visual overfit set of ``overfit_map_check`` (6 images of coloured
rectangles, evaluated on themselves). The reference distils FROM A TRAINED
TEACHER (run_text_train_Student.sh:26-33 with run_text_train_teacher.sh);
joint distillation from scratch does not converge, by design of the method.

  stage 1  TextRes5ROIHeads, DISTILLATE False: the teacher (LV attention
           over the GT-fed keys) and the student both CE-train to
           convergence -> model_final.pth.
  stage 2  a fresh Trainer, MODEL.WEIGHTS = the stage-1 checkpoint; the
           student branch (stu_box_predictor + mlp_adapter) is drawn afresh
           (``surgery_reset_student``, seed 123) and training goes on with
           DISTILLATE, L2 and KL (KL_TEMP 2), under the novel fine-tune's
           gradient contract (FREEZE_FEAT, GDL RPN 0 / ROI 0.001). The cold
           student must converge again, and the KL and L2 losses must fall.

Inference runs the student path, so recall and AP50 measure the distilled
student. The default is the tiny detector on the CPU's shapes;
``--production`` is R-101 at 800x1344 in bf16 with the backbone
rematerialised. It runs on the card unless ``--device cpu``; the seed comes
from ``FSODTF_OVERFIT_SEED`` (default 11).

Prints one JSON line (the losses' first and last three logged values,
AP50, recall, wall seconds, each stage's median step ms from the Trainer's
logged windows), then raises AssertionError when a loss did not fall,
recall@0.5 < 0.9 or AP50 <= 12.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from .overfit_map_check import (
    AP50_MIN,
    RECALL_MIN,
    apply_args,
    detections,
    logged_step_ms,
    production_shapes,
    recall_of,
    register_visual_voc,
    tiny_cfg,
)

TRAIN, TEST = "voc_distof_all1_t_train", "voc_distof_all1_t_test"
RESET_SEED = 123


def base_cfg(production):
    """What both stages share, as the repository's ``_base_cfg``."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 20
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    cfg.MODEL.ROI_HEADS.NAME = "TextRes5ROIHeads"
    cfg.MODEL.ADDITION.NAME = "glove"
    cfg.MODEL.ROI_HEADS.TEACHER_TRAINING = True
    cfg.MODEL.ROI_HEADS.STUDENT_TRAINING = True
    cfg.MODEL.ROI_HEADS.KL_TEMP = 5
    if production:
        production_shapes(cfg)
        # teacher and student heads with full-backbone gradients at
        # 800x1344: rematerialise the backbone, as the repository's tool
        cfg.TPU.REMAT_BACKBONE = True
    else:
        tiny_cfg(cfg)
    cfg.SOLVER.IMS_PER_BATCH = 6
    cfg.SOLVER.BASE_LR = 0.01 if production else 0.02
    cfg.SOLVER.WARMUP_ITERS = 50
    cfg.SOLVER.CHECKPOINT_PERIOD = 0
    cfg.TEST.EVAL_PERIOD = 0
    cfg.DATASETS.TRAIN = (TRAIN,)
    cfg.DATASETS.TEST = (TEST,)
    cfg.SEED = int(os.environ.get("FSODTF_OVERFIT_SEED", "11"))
    return cfg


def stage1_cfg(root, production):
    """Stage 1: teacher and CE student converge (no distillation)."""
    cfg = base_cfg(production)
    cfg.MODEL.ROI_HEADS.DISTILLATE = False
    # lr 0.02 on the 6-image set can fall into an all-background
    # equilibrium depending on the init draw: half the LR, for longer
    cfg.SOLVER.BASE_LR = 0.005 if production else 0.01
    cfg.SOLVER.WARMUP_ITERS = 100
    cfg.SOLVER.MAX_ITER = 400 if production else 600
    cfg.SOLVER.STEPS = (300, 360) if production else (450, 540)
    cfg.OUTPUT_DIR = os.path.join(root, "stage1")
    return cfg


def stage2_cfg(root, production, weights):
    """Stage 2: the cold student distils from the stage-1 teacher, loaded
    from ``weights``."""
    cfg = base_cfg(production)
    cfg.MODEL.ROI_HEADS.DISTILLATE = True
    cfg.MODEL.ROI_HEADS.L2 = True
    cfg.MODEL.ROI_HEADS.KL = True
    cfg.MODEL.WEIGHTS = weights
    # the cold student's ranking (AP) keeps calibrating after recall
    # saturates: longer than stage 1
    cfg.SOLVER.MAX_ITER = 400 if production else 700
    cfg.SOLVER.STEPS = (300, 360) if production else (520, 620)
    # the reference's novel fine-tune gradient contract
    # (defrcn_gfsod_r101_novelx_10shot_seedx.yaml:9-18): GDL RPN 0 / RCNN
    # 0.001 and FREEZE_FEAT, so the cold student's early KL and adapter-L2
    # gradients cannot wreck the loaded backbone and RPN
    cfg.MODEL.RPN.BACKWARD_SCALE = 0.0
    cfg.MODEL.ROI_HEADS.BACKWARD_SCALE = 0.001
    cfg.MODEL.ROI_HEADS.FREEZE_FEAT = True
    cfg.SOLVER.BASE_LR = 0.01
    # the whole student branch starts cold: ramp in over the KL collapse
    cfg.SOLVER.WARMUP_ITERS = 100
    # T = 2: the same mechanism at a 6x smaller x T^2 loss scale
    cfg.MODEL.ROI_HEADS.KL_TEMP = 2
    cfg.OUTPUT_DIR = os.path.join(root, "stage2")
    return cfg


def reset_student(trainer, seed=RESET_SEED):
    """Draw the trainer's student branch afresh in place (the optimizer
    has taken no step: its momentum starts at zero, as after surgery's
    reset). Returns the number of tensors reset."""
    import torch

    from ..checkpoint import surgery_reset_student

    state = {k: v.detach().cpu() for k, v in
             trainer.model.state_dict().items()}
    state, n = surgery_reset_student(state, seed=seed)
    with torch.no_grad():
        trainer.model.load_state_dict(state)
    return n


def main(argv=None):
    """Runs both stages and returns the check's numbers."""
    from .. import cli
    from ..engine import Trainer
    from ..utils.events import read_metrics

    p = argparse.ArgumentParser()
    p.add_argument("--production", action="store_true")
    p.add_argument("--device", default=None,
                   help="MODEL.DEVICE (default: the config's, cuda)")
    p.add_argument("--opts", default=[], nargs=argparse.REMAINDER,
                   help="KEY VALUE pairs merged last (e.g. "
                        "TPU.COMPUTE_DTYPE float32 to look for a bf16 fault)")
    args = p.parse_args(argv)

    root = tempfile.mkdtemp()
    d = register_visual_voc(root, (TRAIN, TEST))
    t0 = time.time()

    cfg1 = apply_args(stage1_cfg(root, args.production), args)
    tr1 = Trainer(cfg1)
    tr1.train()
    ckpt = os.path.join(cfg1.OUTPUT_DIR, "model_final.pth")
    if not os.path.exists(ckpt):
        raise AssertionError(f"stage 1 wrote no {ckpt}")
    print(f"[stage1] teacher trained, checkpoint {ckpt} "
          f"({time.time() - t0:.0f}s)", flush=True)
    del tr1

    cfg2 = apply_args(stage2_cfg(root, args.production, ckpt), args)
    tr2 = Trainer(cfg2)
    n_reset = reset_student(tr2)
    print(f"[stage2] student branch re-randomized ({n_reset} tensors)",
          flush=True)
    tr2.train()

    rows = read_metrics(cfg2.OUTPUT_DIR)
    kl = [r["loss_kl"] for r in rows if "loss_kl" in r]
    l2 = [r["loss_student_feat"] for r in rows if "loss_student_feat" in r]

    def head(xs):
        return float(np.mean(xs[:3]))

    def tail(xs):
        return float(np.mean(xs[-3:]))

    res = cli.do_test(cfg2, model=tr2.model)
    ap50 = res[TEST]["bbox"]["AP50"]
    hit, total = recall_of(detections(cfg2.OUTPUT_DIR), d, TEST)
    out = dict(check="overfit_distill", production=args.production,
               device=cfg2.MODEL.DEVICE, seed=cfg2.SEED,
               loss_kl=[head(kl), tail(kl)],
               loss_student_feat=[head(l2), tail(l2)], ap50=ap50,
               recall=hit / max(total, 1), hit=hit, total=total,
               reset_tensors=n_reset, wall_s=time.time() - t0,
               step_ms_median=[logged_step_ms(cfg1.OUTPUT_DIR),
                               logged_step_ms(cfg2.OUTPUT_DIR)])
    print(json.dumps(out), flush=True)
    failures = []
    if not tail(kl) < head(kl):
        failures.append("KL distillation loss did not decrease")
    if not tail(l2) < head(l2):
        failures.append("L2 feature distillation loss did not decrease")
    if out["recall"] < RECALL_MIN:
        failures.append(f"distilled student recall too low: {out['recall']}")
    if not ap50 > AP50_MIN:
        failures.append(f"distilled student AP50 too low: {ap50}")
    if failures:
        raise AssertionError("; ".join(failures))
    print("DISTILL OVERFIT CHECK PASSED")
    return out


if __name__ == "__main__":
    main()
