"""Every shipped config runs on the port as written: each file of
configs/voc/ and configs/coco/ passes the CLI's checks and builds the
evaluator of each of its test sets (VOC or COCO, on synthetic data from the
port's makers), with nothing refused. The per-seed templates name their
sets with an ``x`` (``voc_2007_test_allx``), which tools/create_config.py
fills in; here split 1 fills it."""

import glob
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
