"""Overfit sanity on this package: the tiny detector trained 150 steps on 6
synthetic VOC images; ``total_loss`` must drop below 0.7 of its first
logged value (the learning signal reaches the weights):

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.overfit_check \\
        [--device cpu]

Counterpart of the repository's ``tools/overfit_check.py``, which builds
the JAX package's end-to-end test config: the same tiny detector (depth
14, widths 8/16/4, 256x384, float32, 20 classes, SEED 7), at BASE_LR 0.02
and batch 4, on the port's ``make_synthetic_voc`` (6 images a year,
split 1) and ``Trainer``. It runs on the card unless ``--device cpu``;
the data and outputs go to a temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

ITERS = 150


def tiny_cfg(out_dir: str, device: str):
    """The tiny detector on split 1's trainval and test sets."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.DEVICE = device
    cfg.MODEL.RESNETS.DEPTH = 14
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 8
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 16
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 4
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 20
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 256
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 256
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 64
    cfg.TPU.IMAGE_BUCKETS = ((256, 384),)
    cfg.TPU.MAX_GT = 10
    cfg.TPU.MAX_DETECTIONS_PRE_NMS = 128
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.INPUT.MIN_SIZE_TRAIN = (256,)
    cfg.INPUT.MAX_SIZE_TRAIN = 384
    cfg.INPUT.MIN_SIZE_TEST = 256
    cfg.INPUT.MAX_SIZE_TEST = 384
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.SOLVER.MAX_ITER = ITERS
    cfg.SOLVER.BASE_LR = 0.02
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.SOLVER.CHECKPOINT_PERIOD = 0
    cfg.DATASETS.TRAIN = ("voc_2007_trainval_all1",)
    cfg.DATASETS.TEST = ("voc_2007_test_all1",)
    cfg.SEED = 7
    cfg.OUTPUT_DIR = out_dir
    return cfg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from ..data import register_all
    from ..engine import Trainer
    from ..utils.events import read_metrics
    from .make_synthetic_voc import make_voc

    with tempfile.TemporaryDirectory() as root:
        datasets = os.path.join(root, "datasets")
        make_voc(datasets, images=6)
        register_all(datasets)
        cfg = tiny_cfg(os.path.join(root, "out"), args.device)
        t0 = time.time()
        Trainer(cfg).train()
        recs = [r for r in read_metrics(cfg.OUTPUT_DIR) if "total_loss" in r]
    first, last = recs[0], recs[-1]
    print("iters:", last["iteration"], "wall:", round(time.time() - t0, 1))
    print("loss first -> last:", round(first["total_loss"], 3), "->",
          round(last["total_loss"], 3))
    assert last["total_loss"] < first["total_loss"] * 0.7, "loss did not drop"
    print("OVERFIT CHECK PASSED")
    return first["total_loss"], last["total_loss"]


if __name__ == "__main__":
    main()
