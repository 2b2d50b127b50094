"""The port's inference_on_dataset against the JAX package's and its
timing, and the Trainer reading the loader and testing as the CLI does;
split from tests/test_torch_eval_cli.py so that each file is a small
share of one xdist worker."""

import json

import numpy as np

import jax

from fewshotobjectdetection_imporove_via_text_feature_tpu.data.loader import (
    build_detection_test_loader as jax_test_loader,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.evaluation import (
    PascalVOCDetectionEvaluator as JaxVOCEvaluator,
    inference_on_dataset as jax_inference_on_dataset,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    build_model as jax_build_model,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    ImageBatch as JaxImageBatch,
)
from fewshotobjectdetection_imporove_via_text_feature_torch import cli
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    state_dict_from_jax_params,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
    build_detection_test_loader,
    get_detection_dataset_dicts,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
    PascalVOCDetectionEvaluator,
    inference_on_dataset,
    voc_ap,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    build_model,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.utils import (
    events,
)
from tests.test_full_network_oracle import _perturb
from tests.test_torch_model import match_detections
from tests.test_torch_eval_cli import (  # noqa: F401
    PREFIX,
    TEST_SET,
    _Recorder,
    _tiny_cfgs,
    voc,
)


def test_inference_on_dataset_matches_the_jax_package(voc):
    cfg, jcfg = _tiny_cfgs()
    jmodel = jax_build_model(jcfg)
    h, w = jcfg.TPU.IMAGE_BUCKETS[0]
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0)},
        JaxImageBatch(image=np.zeros((1, h, w, 3), np.float32),
                      hw=np.array([[h, w]], np.int32),
                      orig_hw=np.array([[h, w]], np.int32)), train=False)
    params = _perturb(jax.device_get(variables["params"]))
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax_params(params))
    model.train()  # inference_on_dataset evaluates, then restores the mode

    ours, ref = _Recorder(), _Recorder()
    inference_on_dataset(model, build_detection_test_loader(
        cfg, TEST_SET, batch_size=4), ours)
    assert model.training
    jax_inference_on_dataset(jmodel, params, jax_test_loader(
        jcfg, PREFIX + TEST_SET, batch_size=4), ref)
    # 6 images in batches of 4: the padded tail's 2 copies never arrive
    assert [len(b[0]) for b in ours.batches] == [4, 2]
    assert [b[0] for b in ours.batches] == [b[0] for b in ref.batches]
    total = 0
    for a, b in zip(ours.batches, ref.batches):
        for i in range(len(a[0])):
            va, vb = a[4][i], b[4][i]
            total += int(va.sum())
            match_detections((a[1][i][va], a[2][i][va], a[3][i][va]),
                             (b[1][i][vb], b[2][i][vb], b[3][i][vb]))
    assert total > 20  # the comparison has teeth

    ap = {}
    for name, rec, ev in (("ours", ours, PascalVOCDetectionEvaluator(
            TEST_SET)), ("ref", ref, JaxVOCEvaluator(PREFIX + TEST_SET))):
        ev.reset()
        for batch in rec.batches:
            ev.process_detections(*batch)
        ap[name] = ev.evaluate()["bbox"]
    assert abs(ap["ours"]["AP50"] - ap["ref"]["AP50"]) <= 1e-6

    # with a PCB: each batch's host detections (original coordinates) and
    # its file names go through execute_calibration before the evaluator
    class _HalvingPCB:
        calls = []

        def execute_calibration(self, image_ids, det, file_names=None):
            self.calls.append((list(image_ids), list(file_names)))
            det["scores"] = det["scores"] * 0.5
            return det

    pcb, rescored = _HalvingPCB(), _Recorder()
    inference_on_dataset(model, build_detection_test_loader(
        cfg, TEST_SET, batch_size=4), rescored, pcb=pcb)
    files = {r["image_id"]: r["file_name"]
             for r in get_detection_dataset_dicts(TEST_SET, False)}
    assert [ids for ids, _ in pcb.calls] == [b[0] for b in ours.batches]
    assert [names for _, names in pcb.calls] == [
        [files[i] for i in b[0]] for b in ours.batches]
    for a, b in zip(rescored.batches, ours.batches):
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2] * 0.5)
    assert inference_on_dataset.last_timing["pcb_s"] > 0


def test_inference_on_dataset_keeps_its_timing(voc):
    """The latest run's image count and per-image times are kept on the
    function; the first NUM_WARMUP batches are left out of the timed
    images."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation.evaluator import (
        NUM_WARMUP,
    )

    cfg, _ = _tiny_cfgs()
    model = build_model(cfg)
    # 6 images, one a batch: the 6th batch is the first one timed
    inference_on_dataset(model, build_detection_test_loader(
        cfg, TEST_SET, batch_size=1), None)
    t = inference_on_dataset.last_timing
    assert (t["images"], t["timed_images"]) == (6, 6 - NUM_WARMUP)
    assert 0 < t["s_per_image"] and 0 < t["wall_s_per_image"]
    assert t["pcb_s"] == 0.0  # no PCB


def test_trainer_reads_the_loader_and_tests_as_the_cli_does(voc, tmp_path):
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        Trainer,
    )

    cfg, _ = _tiny_cfgs()
    cfg.DATASETS.TRAIN = ("voc_2007_trainval_all1",)
    cfg.DATASETS.TEST = (TEST_SET,)
    cfg.SOLVER.MAX_ITER = 2
    cfg.OUTPUT_DIR = str(tmp_path)
    trainer = Trainer(cfg)  # MODEL.DEVICE cpu; batches from the loader
    losses = trainer.train()
    assert np.isfinite(float(losses["total_loss"]))
    rows = (tmp_path / "metrics.json").read_text().splitlines()
    assert [json.loads(r)["iteration"] for r in rows] == [0, 1]
    assert trainer.test() == cli.do_test(cfg, model=trainer.model)
    assert trainer.model.training
