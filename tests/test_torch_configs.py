"""Every shipped config runs on the port as written: each file of
configs/voc/ and configs/coco/ passes the CLI's checks and builds the
evaluator of each of its test sets (VOC or COCO, on synthetic data from the
port's makers), with nothing refused. The per-seed templates name their
sets with an ``x`` (``voc_2007_test_allx``), which tools/create_config.py
fills in; here split 1 fills it."""

import glob
import re
import os

import pytest

from fewshotobjectdetection_imporove_via_text_feature_torch import cli
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
    register_all,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
    COCOEvaluator,
    PascalVOCDetectionEvaluator,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_coco import (
    make_coco,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_voc import (
    make_voc,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "voc", "*.yaml"))
                 + glob.glob(os.path.join(ROOT, "configs", "coco", "*.yaml")))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("configs"))
    make_voc(root, images=2)
    make_coco(root, train_images=2, test_images=2, image_size=(64, 48))
    register_all(root)
    return root


def test_every_config_is_here():
    assert len(CONFIGS) == 31  # 18 VOC, 13 COCO


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.relpath(p, ROOT) for p in CONFIGS])
def test_config_passes_the_cli_and_builds_its_evaluator(datasets, path,
                                                        tmp_path):
    cfg = get_cfg()
    cfg.merge_from_file(path)
    args = cli.default_argument_parser().parse_args(["--config-file", path])
    cli.check_cli_config(cfg, args)
    kind = (PascalVOCDetectionEvaluator if "/voc/" in path
            else COCOEvaluator)
    for name in cfg.DATASETS.TEST:
        name = name.replace("allx", "all1").replace("novelx", "novel1")
        evaluator = cli.build_evaluator(cfg, name, str(tmp_path))
        assert isinstance(evaluator, kind)
        evaluator.reset()


# ---------------------------------------------------------------------------
# the run scripts' --opts on the port (template: test_run_script_combos.py)
from tests.test_run_script_combos import (  # noqa: E402
    _script_paths,
    parse_script_pairs,
    parse_script_pairs_from_text,
)

SCRIPT_IDS = [os.path.basename(p) for p in _script_paths()]
TINY = [
    "MODEL.RESNETS.DEPTH", "14", "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "4",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "MODEL.RPN.POST_NMS_TOPK_TRAIN",
    "32", "MODEL.RPN.PRE_NMS_TOPK_TEST", "64",
    "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "8", "TPU.MAX_GT", "4",
    "TPU.MAX_DETECTIONS_PRE_NMS", "64", "TPU.COMPUTE_DTYPE", "float32",
    "MODEL.DEVICE", "cpu",
]


def _script_blocks():
    """(script, the --opts of each cfg_MODEL block, the config file it
    runs): the blocks' pairs, then every inline pair of the script."""
    out = []
    for path in _script_paths():
        text = open(path).read()
        blocks = re.findall(r'cfg_[A-Z]+="(.*?)"', text, re.S) or [""]
        cfg_file = ("configs/voc/defrcn_det_r101_base1.yaml"
                    if "coco" not in os.path.basename(path)
                    else "configs/coco/defrcn_det_r101_base.yaml")
        for k, block in enumerate(blocks):
            pairs = parse_script_pairs_from_text(block)
            out.append((f"{os.path.basename(path)}[{k}]", cfg_file, pairs))
    return out


BLOCKS = _script_blocks()


@pytest.mark.parametrize("script", _script_paths(), ids=SCRIPT_IDS)
def test_every_script_opt_parses_into_the_port_schema(script):
    pairs = parse_script_pairs(script)
    assert pairs
    cfg = get_cfg()
    cfg.merge_from_list([x for kv in pairs for x in kv])


def _tiny_batch():
    import numpy as np
    import torch

    from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
        GTInstances,
        ImageBatch,
    )

    rng = np.random.RandomState(0)
    hw = torch.tensor([[64, 64]] * 2, dtype=torch.int32)
    images = ImageBatch(torch.from_numpy(
        rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)), hw, hw)
    boxes = torch.tensor([[[4, 4, 40, 40], [20, 20, 60, 60], [0, 0, 0, 0],
                           [0, 0, 0, 0]]] * 2, dtype=torch.float32)
    gt = GTInstances(boxes, torch.zeros(2, 4, dtype=torch.int32),
                     torch.tensor([[True, True, False, False]] * 2))
    return images, gt


@pytest.mark.parametrize("name,cfg_file,pairs", BLOCKS,
                         ids=[b[0] for b in BLOCKS])
def test_run_script_models_build_and_run_on_the_port(name, cfg_file, pairs):
    """Each cfg_MODEL block of each run script, on the config it runs and
    at a tiny size: the model builds (no name refused), takes a training
    step with finite losses (the text heads' teacher, KL and feature
    losses, the Sematic CE, the Distillated res2-res4 losses among them)
    and predicts."""
    import math

    import torch

    from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
        init_weights,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        build_model,
    )

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, cfg_file))
    cfg.merge_from_list([x for kv in pairs for x in kv] + TINY)
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    images, gt = _tiny_batch()
    losses = model.train().forward_train(images, gt,
                                         torch.Generator().manual_seed(1))
    assert all(math.isfinite(v.item()) for v in losses.values()), losses
    roi = cfg.MODEL.ROI_HEADS
    want = set()
    if roi.NAME.startswith("Text"):
        want = {"loss_cls_t", "loss_box_reg_t"}
        if roi.DISTILLATE and roi.KL:
            want.add("loss_kl")
        if roi.DISTILLATE and roi.L2:
            want.add("loss_student_feat")
    if roi.NAME == "SematicRes5ROIHeads":
        want = {"loss_attentive"}
    if cfg.MODEL.META_ARCHITECTURE.startswith("GeneralizedDistillated"):
        want = {"loss_rpn_res2", "loss_rpn_res3", "loss_rpn_res4"}
    assert want <= set(losses), (name, sorted(losses))
    with torch.no_grad():
        det = model.eval().forward_inference(images)
    assert torch.isfinite(det.scores).all()


def test_run_scripts_cover_every_text_head_and_meta_arch():
    heads, metas = set(), set()
    for _, _, pairs in BLOCKS:
        d = dict(pairs)
        heads.add(d.get("MODEL.ROI_HEADS.NAME", "Res5ROIHeads"))
        metas.add(d.get("MODEL.META_ARCHITECTURE", "GeneralizedRCNN"))
    assert {"TextRes5ROIHeads", "TextRes5ROIHeads_textDomination",
            "TextRes5ROIHeads_textDomination_VKV", "SematicRes5ROIHeads",
            "SematicRes5ROIHeadsCrossOutput"} <= heads
    assert "GeneralizedDistillatedRCNN" in metas


@pytest.mark.parametrize("meta,head", [
    ("GeneralizedRCNN", "TextRes5ROIHeads_VKV"),
    ("GeneralizedSemanticRCNN", "Res5ROIHeads"),
    ("GeneralizedDistillatedAddingRCNN", "SematicRes5ROIHeadsCrossOutput"),
    ("GeneralizedTextRCNN", "Res5ROIHeads"),
    ("GeneralizedTextAttRCNN", "Res5ROIHeads")])
def test_text_names_no_script_runs_build_on_the_port(meta, head):
    """The names the JAX package builds that no run script passes."""
    import torch

    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        build_model,
    )

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "voc",
                                     "defrcn_det_r101_base1.yaml"))
    cfg.merge_from_list(TINY + ["MODEL.META_ARCHITECTURE", meta,
                                "MODEL.ROI_HEADS.NAME", head])
    model = build_model(cfg)
    assert type(model).__name__ == meta.replace("Adding", "")
    assert isinstance(model, torch.nn.Module)


def test_distillation_gates_follow_the_flags():
    """DISTILLATE and L2 gate the feature loss, DISTILLATE and KL (True by
    default) the KL loss; KL_TEMP and L2_COSINE reach the head."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        build_model,
    )

    def head(extra):
        cfg = get_cfg()
        cfg.merge_from_list(TINY + ["MODEL.ROI_HEADS.NAME",
                                    "TextRes5ROIHeads",
                                    "DATASETS.TRAIN",
                                    "('voc_2007_trainval_base1',)", *extra])
        return build_model(cfg).roi_heads

    h = head(["MODEL.ROI_HEADS.DISTILLATE", "True", "MODEL.ROI_HEADS.L2",
              "True", "MODEL.ROI_HEADS.KL_TEMP", "5",
              "MODEL.ROI_HEADS.L2_COSINE", "True"])
    assert (h.distill_kl, h.distill_l2, h.kl_temp, h.l2_cosine) == (
        True, True, 5.0, True)
    h = head(["MODEL.ROI_HEADS.DISTILLATE", "True", "MODEL.ROI_HEADS.KL",
              "False"])
    assert (h.distill_kl, h.distill_l2) == (False, False)
    h = head([])
    assert (h.distill_kl, h.distill_l2) == (False, False)
