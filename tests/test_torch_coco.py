"""The port's COCO data and evaluation against the JAX package's, on the CPU.

* ``load_coco_json``: the records of the full, base, novel and k-shot names
  on a synthetic COCO tree (the port's maker) equal the JAX package's.
* ``evaluate_coco_detections``: every golden and hand-derived case of
  tests/test_coco_eval_golden.py and tests/test_coco_eval_fixtures.py runs
  with both packages' functions, whose metrics must agree to 1e-12 (the
  same float64 arithmetic), and so must a seeded fuzz set.
* The pipeline: json -> registry -> COCOEvaluator with base/novel splits on
  perfect detections, equal to the JAX evaluator (its results file too);
  then the CLI on a COCO fine-tune config at tiny size, one training step
  and the evaluation with PCB on.
"""

import json
import logging
import os

import numpy as np
import pytest

import test_coco_eval_fixtures as fixtures
import test_coco_eval_golden as golden

from fewshotobjectdetection_imporove_via_text_feature_tpu.data import (
    DatasetCatalog as JaxDatasetCatalog,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data.builtin_meta import (
    _get_builtin_metadata as jax_builtin_metadata,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data.meta_coco import (
    register_meta_coco as jax_register_meta_coco,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.evaluation.coco_eval import (
    COCOEvaluator as JaxCOCOEvaluator,
    evaluate_coco_detections as jax_evaluate,
)
from fewshotobjectdetection_imporove_via_text_feature_torch import cli
from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
    DatasetCatalog,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data.builtin_meta import (
    _get_builtin_metadata,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data.meta_coco import (
    register_meta_coco,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
    COCOEvaluator,
    evaluate_coco_detections,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_coco import (
    make_coco,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "torchcoco_"
NAMES = ("coco14_test_all", "coco14_test_base", "coco14_test_novel",
         "coco14_trainval_all", "coco14_trainval_base",
         "coco14_trainval_all_1shot_seed0", "coco14_trainval_novel_2shot_seed1")


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """A synthetic COCO tree (32 trainval and 12 test images of 96x64),
    registered under PREFIX names in both packages."""
    root = str(tmp_path_factory.mktemp("coco"))
    make_coco(root, train_images=32, test_images=12, shots=(1, 2),
              seeds=(0, 1), image_size=(96, 64))
    for name in NAMES:
        test = "test" in name
        imgdir = os.path.join(root, "coco", "val2014" if test
                              else "trainval2014")
        anno = "" if "shot" in name else os.path.join(
            root, "cocosplit", "datasplit",
            "5k.json" if test else "trainvalno5k.json")
        if PREFIX + name not in DatasetCatalog:
            register_meta_coco(PREFIX + name,
                               _get_builtin_metadata("coco_fewshot"), imgdir,
                               anno, root=root)
        if PREFIX + name not in JaxDatasetCatalog:
            jax_register_meta_coco(PREFIX + name,
                                   jax_builtin_metadata("coco_fewshot"),
                                   imgdir, anno, root=root)
    return root


@pytest.mark.parametrize("name", NAMES)
def test_records_equal_the_jax_package(coco, name):
    ours = DatasetCatalog.get(PREFIX + name)
    assert ours == JaxDatasetCatalog.get(PREFIX + name)
    assert ours and any(r["annotations"] for r in ours)
    if "1shot" in name:  # one image a class: every class of the split
        assert len({a["category_id"] for r in ours
                    for a in r["annotations"]}) == 80


def _both(gt, dets, class_ids):
    """Both packages' metrics, equal to 1e-12 (NaN where the other is)."""
    ours = evaluate_coco_detections(gt, dets, class_ids)
    theirs = jax_evaluate(gt, dets, class_ids)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        if np.isnan(v):
            assert np.isnan(ours[k]), k
        else:
            assert abs(ours[k] - v) <= 1e-12, (k, ours[k], v)
    return theirs


CASES = [(m, n) for m in (golden, fixtures) for n in sorted(vars(m))
         if n.startswith("test_")]


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m.__name__}.{n}" for m, n in CASES])
def test_golden_and_fixture_cases_equal_the_jax_package(monkeypatch, module,
                                                        name):
    """Each case runs as written, with ``evaluate_coco_detections`` giving
    the JAX package's metrics after checking the port's against them."""
    monkeypatch.setattr(module, "evaluate_coco_detections", _both)
    getattr(module, name)()


@pytest.mark.parametrize("seed", range(100, 106))
def test_fuzz_equals_the_jax_package(seed):
    _both(*golden._fuzz_case(seed))


def test_evaluator_with_splits_equals_the_jax_package(coco, tmp_path):
    name = PREFIX + "coco14_test_all"
    outs = []
    for make, sub in ((COCOEvaluator, "ours"), (JaxCOCOEvaluator, "jax")):
        evaluator = make(name, str(tmp_path / sub))
        evaluator.reset()
        for r in DatasetCatalog.get(name):  # perfect detections
            boxes = np.array([a["bbox"] for a in r["annotations"]],
                             np.float32)
            classes = np.array([a["category_id"] for a in r["annotations"]],
                               np.int32)
            n = len(boxes)
            evaluator.process_detections(
                [r["image_id"]], boxes[None], np.full((1, n), 0.9,
                                                      np.float32),
                classes[None], np.ones((1, n), bool))
        outs.append(evaluator.evaluate()["bbox"])
    np.testing.assert_equal(outs[0], outs[1])  # NaN where no GT
    for k in ("AP", "AP50", "bAP", "nAP"):
        assert np.isclose(outs[0][k], 100.0), k
    files = [json.load(open(tmp_path / s / "coco_instances_results.json"))
             for s in ("ours", "jax")]
    assert files[0] == files[1] and files[0]


@pytest.fixture
def root_logging():
    """Leave the root logger's handlers and level as they were."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in root.handlers[:]:
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)


def test_cli_fine_tunes_and_evaluates_coco_with_pcb(coco, tmp_path,
                                                    monkeypatch,
                                                    root_logging):
    """The COCO gfsod 1-shot config through the CLI at tiny size, on the
    built-in names: one training step, then the evaluation of the test set
    with PCB on (COCO's base classes excluded)."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
        inference_on_dataset,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
        pcb as pcb_module,
    )
    from test_torch_eval_cli import TINY_OPTS

    built = []

    class _Kept(pcb_module.PrototypicalCalibrationBlock):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    # keep the block the CLI builds
    monkeypatch.setattr(pcb_module, "PrototypicalCalibrationBlock", _Kept)
    monkeypatch.setenv("FSODTF_DATASETS", coco)
    out = str(tmp_path / "coco_1shot")
    config = os.path.join(ROOT, "configs", "coco",
                          "defrcn_gfsod_r101_novel_1shot_seedx.yaml")
    results = cli.main([
        "--config-file", config, "--opts", *TINY_OPTS,
        "DATASETS.TRAIN", "('coco14_trainval_all_1shot_seed0',)",
        "TEST.PCB_MODELPATH", "", "SOLVER.MAX_ITER", "1",
        "SOLVER.CHECKPOINT_PERIOD", "0", "OUTPUT_DIR", out])
    bbox = results["coco14_test_all"]["bbox"]
    for k in ("AP", "AP50", "bAP", "nAP"):
        assert np.isfinite(bbox[k]), (k, bbox)
    assert len(built) == 1
    pcb = built[0]
    assert len(pcb.exclude_cls) == 60
    assert inference_on_dataset.last_timing["pcb_s"] > 0
    assert sorted(pcb.prototypes) == list(range(80))
