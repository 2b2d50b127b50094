"""The port's evaluation, CLI and workflow tools against the JAX package's,
on the CPU at tiny size: the VOC evaluator, ``inference_on_dataset`` on
the same weights, the log contract that ``tools/extract_results.py``
reads, ``--resume`` and ``--eval-iter``, the refusals of what is not
ported, and checkpoint surgery from the command line.

Tolerances: AP from the same detections is equal (the same float64
arithmetic); detections of the same weights are set-matched (class equal,
IoU >= 0.99, score within 1e-4, counts equal) and AP50 within 1e-6 points
of the JAX package's; everything else is exact.
"""

import json
import logging
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import jax

from fewshotobjectdetection_imporove_via_text_feature_tpu.checkpoint.checkpointer import (
    Checkpointer as JaxCheckpointer,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.config import (
    get_cfg as jax_get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data import (
    DatasetCatalog as JaxDatasetCatalog,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data.builtin_meta import (
    _get_builtin_metadata as jax_builtin_metadata,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data.meta_voc import (
    register_meta_voc as jax_register_meta_voc,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.evaluation import (
    PascalVOCDetectionEvaluator as JaxVOCEvaluator,
    voc_ap as jax_voc_ap,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    build_model as jax_build_model,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    ImageBatch as JaxImageBatch,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.utils import (
    events as jax_events,
)
from fewshotobjectdetection_imporove_via_text_feature_torch import cli
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    state_dict_from_jax_params,
    surgery_randinit,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
    build_detection_test_loader,
    register_all,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine.hooks import (
    EvalHook,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
    DatasetEvaluator,
    PascalVOCDetectionEvaluator,
    inference_on_dataset,
    voc_ap,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    build_model,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    model_surgery,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_voc import (
    make_voc,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.utils import (
    events,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "torchevalcli_"
TEST_SET = "voc_2007_test_all1"

# the tiny detector of tests/test_end_to_end.py's CLI test
TINY_OPTS = [
    "MODEL.WEIGHTS", "", "MODEL.DEVICE", "cpu",
    "MODEL.RESNETS.DEPTH", "14", "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "4", "MODEL.BACKBONE.FREEZE_AT", "0",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "128",
    "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "128", "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "8",
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
    "TPU.IMAGE_BUCKETS", "((192,256),)", "TPU.MAX_GT", "10",
    "TPU.MAX_DETECTIONS_PRE_NMS", "64", "TPU.COMPUTE_DTYPE", "float32",
    "INPUT.MIN_SIZE_TRAIN", "(192,)", "INPUT.MAX_SIZE_TRAIN", "256",
    "INPUT.MIN_SIZE_TEST", "192", "INPUT.MAX_SIZE_TEST", "256",
    "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.001",
    "SOLVER.WARMUP_ITERS", "0", "SEED", "3",
]
BASE1 = os.path.join(ROOT, "configs", "voc", "defrcn_det_r101_base1.yaml")


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """One synthetic VOC (6 images a year), registered under the built-in
    names in the port and under PREFIX names in the JAX package."""
    root = str(tmp_path_factory.mktemp("voc"))
    make_voc(root, images=6)
    register_all(root)
    if PREFIX + TEST_SET not in JaxDatasetCatalog:
        jax_register_meta_voc(PREFIX + TEST_SET,
                              jax_builtin_metadata("voc_fewshot"),
                              os.path.join(root, "VOC2007"), "test", 2007,
                              "base_novel_1", 1, root=root)
    return root


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


def _tiny_cfgs():
    cfg = get_cfg()
    cfg.merge_from_list(TINY_OPTS)
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 20
    jcfg = jax_get_cfg()
    jcfg.merge_from_list([o for pair in zip(TINY_OPTS[0::2], TINY_OPTS[1::2])
                          if pair[0] != "MODEL.DEVICE" for o in pair])
    jcfg.MODEL.ROI_HEADS.NUM_CLASSES = 20
    jcfg.TPU.HOST_SPACE_TO_DEPTH = False
    return cfg, jcfg


def _detections(rng, n_images, n=12, num_classes=20):
    """Padded detections near the synthetic GT boxes and at random."""
    boxes = np.zeros((n_images, n, 4), np.float32)
    for i in range(n_images):
        for k in range(n):
            x1, y1 = 9 + 40 * (k % 3), 14 + 30 * (k % 3)
            jitter = rng.uniform(-12, 12, 4) if k < 9 else \
                rng.uniform(0, 150, 4)
            boxes[i, k] = [x1, y1, x1 + 91, y1 + 81] + jitter
    boxes[..., 2:] = np.maximum(boxes[..., 2:], boxes[..., :2] + 1)
    scores = rng.uniform(0.05, 1.0, (n_images, n)).astype(np.float32)
    classes = rng.randint(0, num_classes, (n_images, n)).astype(np.int32)
    valid = rng.uniform(size=(n_images, n)) < 0.9
    return boxes, scores, classes, valid


def test_voc_evaluator_equals_the_jax_evaluator(voc):
    ours = PascalVOCDetectionEvaluator(TEST_SET)
    ref = JaxVOCEvaluator(PREFIX + TEST_SET)
    ids = [f"{i:06d}" for i in range(6)]
    rng = np.random.RandomState(5)
    for ev in (ours, ref):
        ev.reset()
    for _ in range(2):  # two batches, the second partly the same images
        det = _detections(rng, len(ids))
        for ev in (ours, ref):
            ev.process_detections(ids, *det)
    a, b = ours.evaluate(), ref.evaluate()
    assert a == b
    assert set(a["bbox"]) == {"AP", "AP50", "AP75", "bAP", "bAP50", "bAP75",
                              "nAP", "nAP50", "nAP75"}
    assert a["bbox"]["AP50"] > 1.0  # the jittered boxes hit their GT


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_ap_equals_the_jax_voc_ap(use_07):
    rng = np.random.RandomState(int(use_07))
    rec = np.sort(rng.uniform(size=40))
    prec = rng.uniform(size=40)
    assert voc_ap(rec, prec, use_07) == jax_voc_ap(rec, prec, use_07)


class _Recorder(DatasetEvaluator):
    def reset(self):
        self.batches = []

    def process_detections(self, image_ids, boxes, scores, classes, valid):
        self.batches.append((list(image_ids), *(np.asarray(x) for x in
                                                (boxes, scores, classes,
                                                 valid))))

    def evaluate(self):
        return {}


def _run_cli(argv):
    return cli.main(["--config-file", BASE1, *argv])


def test_cli_trains_evaluates_resumes_and_keeps_the_log_contract(
        voc, tmp_path, monkeypatch, root_logging):
    monkeypatch.setenv("FSODTF_DATASETS", voc)
    runs = tmp_path / "runs"
    out = str(runs / "1shot_seed0")
    opts = TINY_OPTS + ["SOLVER.MAX_ITER", "2", "SOLVER.STEPS", "(1,)",
                        "SOLVER.CHECKPOINT_PERIOD", "2", "OUTPUT_DIR", out]
    results = _run_cli(["--opts", *opts])
    bbox = results["voc_2007_test_base1"]["bbox"]
    assert set(bbox) == {"AP", "AP50", "AP75", "bAP", "bAP50", "bAP75"}
    assert all(np.isfinite(v) for v in bbox.values())
    for name in ("config.yaml", "metrics.json", "model_0000001.pth",
                 "model_final.pth", "coco_instances_results.json"):
        assert os.path.exists(os.path.join(out, name)), name
    log = os.path.join(out, "log.txt")
    lines = [ln.strip() for ln in open(log) if ln.strip()]
    assert "copypaste" in lines[-1] and "copypaste" in lines[-2], lines[-3:]
    vals = lines[-1].split(":")[-1].split(",")
    assert len(vals) == 6 and all(float(v) >= 0.0 for v in vals)

    # --resume continues from the saved iteration, it does not start over
    resume = list(opts)
    resume[resume.index("SOLVER.MAX_ITER") + 1] = "4"
    resume[resume.index("SOLVER.STEPS") + 1] = "(3,)"
    _run_cli(["--resume", "--opts", *resume])
    iters = [ln.strip() for ln in open(log) if "iter " in ln]
    assert [ln for ln in iters if "iter 3 " in ln], iters[-5:]
    assert sum("iter 0 " in ln for ln in iters) == 1, iters

    # --eval-iter 2 evaluates model_0000001.pth
    res = _run_cli(["--eval-only", "--eval-iter", "2", "--opts", *opts])
    assert res["voc_2007_test_base1"]["bbox"] == bbox

    # tools/extract_results.py reads the last copypaste rows of log.txt
    argv = sys.argv
    sys.argv = ["extract_results.py", "--res-dir", str(runs),
                "--shot-list", "1"]
    try:
        runpy.run_path(os.path.join(ROOT, "tools", "extract_results.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    table = (runs / "results.txt").read_text()
    assert "--> 1-shot" in table and "bAP50" in table


@pytest.mark.parametrize("argv,error,match", [
    # more than one machine needs machine 0's address, as in the JAX CLI
    (["--num-machines", "2"], ValueError, "dist-url"),
    # a serving option, refused by evaluation as in the JAX package
    (["--opts", "TPU.SPATIAL_PARTITION", "2"], ValueError,
     "DefaultPredictor serving"),
    (["--opts", "TEST.PCB_ENABLE", "True", "TEST.PCB_MODELTYPE", "vgg"],
     NotImplementedError, "PCB_MODELTYPE"),
    # ZeRO over one process: the model axis must divide the world
    (["--opts", "TPU.MODEL_PARALLEL", "2"], ValueError, "world size 1"),
])
def test_cli_refuses_what_is_not_ported(voc, tmp_path, monkeypatch,
                                        root_logging, argv, error, match):
    monkeypatch.setenv("FSODTF_DATASETS", voc)
    base = ["--opts", *TINY_OPTS, "SOLVER.MAX_ITER", "1",
            "OUTPUT_DIR", str(tmp_path)]
    if argv[0] == "--opts":
        base += argv[1:]
        argv = []
    with pytest.raises(error, match=match):
        _run_cli(argv + base)


def test_cli_refuses_to_leave_cuda_quietly(voc, tmp_path, monkeypatch,
                                           root_logging):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    monkeypatch.setenv("FSODTF_DATASETS", voc)
    opts = TINY_OPTS + ["MODEL.DEVICE", "cuda", "OUTPUT_DIR", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run_cli(["--eval-only", "--opts", *opts])


def test_resolve_eval_iter_checkpoint_finds_both_formats(tmp_path):
    (tmp_path / "model_0000999.pth").write_bytes(b"")
    (tmp_path / "model_0000499.ckpt").write_bytes(b"")
    assert cli.resolve_eval_iter_checkpoint(str(tmp_path), 1000).endswith(
        "model_0000999.pth")
    assert cli.resolve_eval_iter_checkpoint(str(tmp_path), 500).endswith(
        "model_0000499.ckpt")
    with pytest.raises(FileNotFoundError):
        cli.resolve_eval_iter_checkpoint(str(tmp_path), 7)


def test_copypaste_and_verify_results_equal_the_jax_package(caplog):
    results = {"bbox": {"AP": 12.3456, "AP50": 40.0, "bAP50": 41.5,
                        "nAP50": float("nan")}}
    with caplog.at_level(logging.INFO):
        events.print_csv_format(results)
        ours = [r.getMessage() for r in caplog.records]
        caplog.clear()
        jax_events.print_csv_format(results)
        ref = [r.getMessage() for r in caplog.records]
    assert ours == ref and ours[-1] == "copypaste: 12.3456,40.0000,41.5000,nan"
    cfg, jcfg = get_cfg(), jax_get_cfg()
    for expected in ((), (("bbox", "AP50", 39.0, 2.0),),
                     (("bbox", "AP50", 30.0, 2.0),),
                     (("bbox", "nAP50", 0.0, 100.0),),
                     (("bbox", "missing", 0.0, 1.0),)):
        cfg.TEST.EXPECTED_RESULTS = jcfg.TEST.EXPECTED_RESULTS = expected
        assert events.verify_results(cfg, results) == \
            jax_events.verify_results(jcfg, results)
    assert events.flatten_results_dict({"a": {"b": 1, "c": {"d": 2}}}) == \
        jax_events.flatten_results_dict({"a": {"b": 1, "c": {"d": 2}}})


def test_eval_hook_writes_periodic_and_final_results(tmp_path):
    calls = []

    def eval_fn():
        calls.append(1)
        return {"bbox": {"AP50": 10.0 * len(calls)}}

    hook = EvalHook(period=2, max_iter=5, output_dir=str(tmp_path),
                    eval_fn=eval_fn)
    for it in range(5):
        hook(it)
    assert len(calls) == 3  # iterations 1, 3 and the last, 4
    out = tmp_path / "inference"
    assert sorted(p.name for p in out.iterdir()) == [
        "iter_0000001.json", "iter_0000003.json", "res_final.json"]
    assert (out / "res_final.json").read_text() == '{"bbox/AP50": 30.0}'


def test_model_surgery_tool_reads_a_pth_and_a_jax_ckpt(tmp_path):
    cfg, jcfg = _tiny_cfgs()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = jcfg.MODEL.ROI_HEADS.NUM_CLASSES = 15
    jmodel = jax_build_model(jcfg)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(1)},
        JaxImageBatch(image=np.zeros((1, 64, 64, 3), np.float32),
                      hw=np.array([[64, 64]], np.int32),
                      orig_hw=np.array([[64, 64]], np.int32)), train=False)
    params = jax.device_get(variables["params"])
    state = state_dict_from_jax_params(params)
    want = surgery_randinit(state, 20, dataset="voc", seed=0)
    torch.save({"model": state, "optimizer": {}, "iteration": 9},
               tmp_path / "model_final.pth")
    JaxCheckpointer(str(tmp_path)).save({"params": params, "iteration": 9},
                                        "model_final")
    for src in ("model_final.pth", "model_final.ckpt"):
        out = model_surgery.main([
            "--dataset", "voc", "--method", "randinit",
            "--src-path", str(tmp_path / src), "--save-dir",
            str(tmp_path / src.replace(".", "_"))])
        got = torch.load(out, weights_only=True)
        assert got["iteration"] == 0 and "optimizer" not in got
        assert set(got["model"]) == set(want)
        for k in want:
            assert torch.equal(got["model"][k], want[k]), k
    assert want["roi_heads.box_predictor.cls_score.weight"].shape[0] == 21
    build_model(cfg.clone()).load_state_dict(state)  # 15 classes before


def test_merge_from_list_parses_overrides_like_the_jax_config():
    opts = [o for pair in zip(TINY_OPTS[0::2], TINY_OPTS[1::2])
            if pair[0] != "MODEL.DEVICE" for o in pair]
    opts += ["TEST.EXPECTED_RESULTS", "[('bbox','bAP50',0.9,0.85)]",
             "TEST.PCB_ENABLE", "False", "SOLVER.STEPS", "(4,)"]
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_list(opts)
    jcfg.merge_from_list(opts)
    for key in opts[0::2]:
        a, b = cfg, jcfg
        for part in key.split("."):
            a, b = a[part], b[part]
        assert a == b and type(a) is type(b), key
    with pytest.raises(KeyError):
        cfg.merge_from_list(["MODEL.NO_SUCH_KEY", "1"])
    with pytest.raises(ValueError):
        cfg.merge_from_list(["SEED"])
