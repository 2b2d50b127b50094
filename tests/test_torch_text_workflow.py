"""The text families' workflow on the port's command line, on the CPU at
tiny size on synthetic VOC: teacher base training (TextRes5ROIHeads, no
distillation) -> randinit surgery 15 -> 20 -> ``reset_student`` -> the
gfsod 1-shot student fine-tune with the distillation flags of
run_text_train_student.sh -> evaluation, and the log contract. Then the
evaluation of a GT-painting meta-arch (GeneralizedTextRCNN) through
``inference_on_dataset`` against the JAX package's on the same weights
and test batches, with test-time GT and with TEST.NO_GT_EVAL.
"""

import os
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

from fewshotobjectdetection_imporove_via_text_feature_tpu.data.loader import (
    build_detection_test_loader as jax_test_loader,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.evaluation import (
    inference_on_dataset as jax_inference_on_dataset,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    build_model as jax_build_model,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    GTInstances as JaxGT,
    ImageBatch as JaxImageBatch,
)
from fewshotobjectdetection_imporove_via_text_feature_torch import cli
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    load_reference_weights,
    state_dict_from_jax_params,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
    build_detection_test_loader,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
    inference_on_dataset,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    build_model,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    model_surgery,
)
from tests.test_full_network_oracle import _perturb
from tests.test_torch_eval_cli import (  # noqa: F401  (fixtures)
    BASE1,
    PREFIX,
    ROOT,
    TEST_SET,
    TINY_OPTS,
    _Recorder,
    _tiny_cfgs,
    root_logging,
    voc,
)
from tests.test_torch_model import match_detections

TEACHER = ["MODEL.ROI_HEADS.NAME", "TextRes5ROIHeads",
           "MODEL.ROI_HEADS.TEACHER_TRAINING", "True",
           "MODEL.ROI_HEADS.STUDENT_TRAINING", "False",
           "MODEL.ROI_HEADS.DISTILLATE", "False"]
STUDENT = ["MODEL.ROI_HEADS.NAME", "TextRes5ROIHeads",
           "MODEL.ROI_HEADS.TEACHER_TRAINING", "False",
           "MODEL.ROI_HEADS.STUDENT_TRAINING", "True",
           "MODEL.ROI_HEADS.DISTILLATE", "True", "MODEL.ROI_HEADS.KL", "True",
           "MODEL.ROI_HEADS.L2", "True", "MODEL.ROI_HEADS.KL_TEMP", "5"]


def _last_losses(out):
    import json

    lines = open(os.path.join(out, "metrics.json")).read().splitlines()
    return json.loads(lines[-1])


def test_teacher_randinit_reset_student_student_eval(voc, tmp_path,
                                                     monkeypatch,
                                                     root_logging):
    monkeypatch.setenv("FSODTF_DATASETS", voc)
    base = str(tmp_path / "teacher_base")
    # 1. the teacher: base training and its evaluation
    res = cli.main(["--config-file", BASE1, "--opts", *TINY_OPTS, *TEACHER,
                    "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", base])
    assert np.isfinite(res["voc_2007_test_base1"]["bbox"]["AP50"])
    losses = _last_losses(base)
    assert {"loss_cls_t", "loss_box_reg_t"} <= set(losses)
    assert "loss_kl" not in losses and "loss_student_feat" not in losses
    # 2. randinit 15 -> 20, 3. the cold student
    wide = model_surgery.main([
        "--dataset", "voc", "--method", "randinit", "--src-path",
        os.path.join(base, "model_final.pth"), "--save-dir", base])
    cold = model_surgery.main([
        "--dataset", "voc", "--method", "reset_student", "--src-path", wide,
        "--save-dir", base, "--seed", "123"])
    a = torch.load(wide, weights_only=True)["model"]
    b = torch.load(cold, weights_only=True)["model"]
    changed = {k for k in a if not torch.equal(a[k], b[k])}
    assert changed and all(".stu_box_predictor." in k or ".mlp_adapter." in k
                           for k in changed)
    assert a["roi_heads.box_predictor.cls_score.weight"].shape[0] == 21
    assert a["roi_heads.stu_box_predictor.cls_score.weight"].shape[0] == 16
    # 4. the per-seed config, 5. the student fine-tune and its evaluation
    configs = tmp_path / "configs"
    shutil.copytree(os.path.join(ROOT, "configs"), configs)
    argv = sys.argv
    sys.argv = ["create_config.py", "--dataset", "voc", "--config_root",
                str(configs / "voc"), "--shot", "1", "--seed", "0",
                "--setting", "gfsod", "--split", "1"]
    try:
        runpy.run_path(os.path.join(ROOT, "tools", "create_config.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    ft = str(configs / "voc" / "defrcn_gfsod_r101_novel1_1shot_seed0.yaml")
    out = str(tmp_path / "runs" / "1shot_seed0")
    res = cli.main(["--config-file", ft, "--opts", *TINY_OPTS, *STUDENT,
                    "MODEL.WEIGHTS", cold, "SOLVER.MAX_ITER", "2",
                    "TEST.PCB_ENABLE", "False", "OUTPUT_DIR", out])
    bbox = res["voc_2007_test_all1"]["bbox"]
    assert all(np.isfinite(bbox[k]) for k in ("AP50", "bAP50", "nAP50"))
    losses = _last_losses(out)
    assert {"loss_cls_t", "loss_kl", "loss_student_feat"} <= set(losses)
    assert all(np.isfinite(v) for v in losses.values())
    lines = [ln.strip() for ln in open(os.path.join(out, "log.txt"))
             if ln.strip()]
    assert "copypaste" in lines[-1] and "copypaste" in lines[-2]
    # the student of base width kept its seeded values; the teacher loaded
    cfg = cli.setup(cli.default_argument_parser().parse_args(
        ["--config-file", ft, "--opts", *TINY_OPTS, *STUDENT,
         "OUTPUT_DIR", str(tmp_path / "probe")]))
    model = build_model(cfg)
    matched, skipped = load_reference_weights(cold, model)
    assert sorted(skipped) == sorted(
        k for k in b if k.startswith("roi_heads.stu_box_predictor."))


def _jax_text_model(jcfg):
    jmodel = jax_build_model(jcfg)
    h, w = jcfg.TPU.IMAGE_BUCKETS[0]
    images = JaxImageBatch(image=np.zeros((1, h, w, 3), np.float32),
                           hw=np.array([[h, w]], np.int32),
                           orig_hw=np.array([[h, w]], np.int32))
    gt = JaxGT(boxes=np.array([[[8, 8, 90, 90]]], np.float32),
               classes=np.zeros((1, 1), np.int32),
               valid=np.ones((1, 1), bool))
    variables = jax.jit(lambda r: jmodel.init(r, images, gt, train=False))(
        {"params": jax.random.PRNGKey(0)})
    return jmodel, _perturb(jax.device_get(variables["params"]))


@pytest.mark.parametrize("no_gt", [False, True])
def test_text_rcnn_evaluation_matches_the_jax_package(voc, no_gt):
    """GeneralizedTextRCNN ("paint"): with GT each test batch's boxes are
    painted into the features on both sides; with TEST.NO_GT_EVAL both
    paint every cell background."""
    cfg, jcfg = _tiny_cfgs()
    for c in (cfg, jcfg):
        c.MODEL.META_ARCHITECTURE = "GeneralizedTextRCNN"
        c.DATASETS.TRAIN = ("voc_2007_trainval_all1",)
    jmodel, params = _jax_text_model(jcfg)
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax_params(params))
    ours, ref = _Recorder(), _Recorder()
    inference_on_dataset(model, build_detection_test_loader(
        cfg, TEST_SET, batch_size=4), ours, no_gt=no_gt)
    jax_inference_on_dataset(jmodel, params, jax_test_loader(
        jcfg, PREFIX + TEST_SET, batch_size=4), ref, no_gt=no_gt)
    assert [b[0] for b in ours.batches] == [b[0] for b in ref.batches]
    total = 0
    for a, b in zip(ours.batches, ref.batches):
        for i in range(len(a[0])):
            va, vb = a[4][i], b[4][i]
            total += int(va.sum())
            match_detections((a[1][i][va], a[2][i][va], a[3][i][va]),
                             (b[1][i][vb], b[2][i][vb], b[3][i][vb]))
    assert total > 20
