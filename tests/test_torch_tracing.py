"""The port's spans (``utils/tracing.py``) on the CPU: the shared no-op
while no profiler collects, each evaluation batch's and training step's
spans under ``torch.profiler``, the model's stages nested inside them in
order, and no profiler op in an exported serving program. The trainer's
profile window is tested in tests/test_torch_trainer_profile.py."""

import json

import numpy as np
import torch

from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    init_weights,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    make_train_step,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine.export import (
    export_program,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
    inference_on_dataset,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    build_model,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.solver import (
    build_optimizer,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
    GTInstances,
    ImageBatch,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.utils.tracing import (
    span,
)

TINY = [
    "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", "",
    "MODEL.RESNETS.DEPTH", "14",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "4",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "128",
    "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "128",
    "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
    "MODEL.ROI_HEADS.NUM_CLASSES", "5",
    "TPU.COMPUTE_DTYPE", "float32",
]
H, W = 128, 192
STAGES = ["normalize", "backbone", "branch", "rpn", "roi_heads"]


def _model():
    cfg = get_cfg()
    cfg.merge_from_list(list(TINY))
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    return cfg, model


def _batch(seed):
    g = torch.Generator().manual_seed(seed)
    image = torch.randint(0, 256, (2, H, W, 3), generator=g,
                          dtype=torch.uint8).float()
    hw = torch.tensor([[H, W], [96, 160]], dtype=torch.int32)
    boxes = torch.tensor([[[8.0, 8.0, 60.0, 70.0], [40.0, 30.0, 120.0, 100.0]],
                          [[10.0, 20.0, 50.0, 90.0], [0.0, 0.0, 0.0, 0.0]]])
    gt = GTInstances(boxes, torch.tensor([[1, 3], [2, 0]], dtype=torch.int32),
                     torch.tensor([[True, True], [True, False]]))
    return ImageBatch(image=image, hw=hw, orig_hw=hw * 2), gt


def _profiled(fn, tmp_path):
    """``fn()`` under ``torch.profiler``; the ``fsod.`` spans of its chrome
    trace as (name without the prefix, start, end), by start."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"][len("fsod."):], e["ts"], e["ts"] + e["dur"])
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("fsod.")), key=lambda s: s[1])


def _inside(spans, outer):
    """The names of the spans inside each span named ``outer``, by start."""
    return [[n for n, s, e in spans if s0 <= s and e <= e0 and n != outer]
            for name, s0, e0 in spans if name == outer]


class _Rescorer:
    """A stand-in for PCB: the detections as they come."""

    def execute_calibration(self, ids, det, file_names=None):
        return det


def test_span_is_the_shared_noop_while_no_profiler_collects(tmp_path):
    assert span("backbone") is span("eval.fetch")
    assert not isinstance(span("rpn"), torch.profiler.record_function)

    def opened_before_the_profiler():
        torch.ones(3).sum()

    with span("outer"):
        spans = _profiled(opened_before_the_profiler, tmp_path)
    assert spans == []


def test_inference_spans_each_batch_with_the_stages_inside_the_forward(
        tmp_path):
    _, model = _model()
    batches = [(images, gt, {"image_ids": [2 * k, 2 * k + 1]})
               for k, (images, gt) in enumerate([_batch(1), _batch(2)])]
    spans = _profiled(lambda: inference_on_dataset(
        model, batches, None, pcb=_Rescorer()), tmp_path)
    names = [n for n, _, _ in spans]
    for stage in ("eval.forward", "eval.to_host", "eval.pcb",
                  "eval.collect"):
        assert names.count(stage) == 2, (stage, names)
    # each batch's fetch, and the one that finds the loader's end
    assert names.count("eval.fetch") == 3
    assert _inside(spans, "eval.forward") == [STAGES + ["detections"]] * 2
    for outer in ("eval.fetch", "eval.to_host", "eval.pcb", "eval.collect"):
        assert _inside(spans, outer) == [[]] * names.count(outer)
    # the batch's stages in the loop's order
    order = [n for n in names if n.startswith("eval.")]
    assert order == ["eval.fetch", "eval.forward", "eval.to_host",
                     "eval.pcb", "eval.collect"] * 2 + ["eval.fetch"]


def test_train_step_spans_its_phases_with_the_stages_inside_the_forward(
        tmp_path):
    cfg, model = _model()
    model.train()
    step = make_train_step(model, build_optimizer(cfg, model), seed=3)
    images, gt = _batch(4)
    losses = {}
    spans = _profiled(lambda: losses.update(step(images, gt, 0)), tmp_path)
    assert np.isfinite(float(losses["total_loss"]))
    top = [n for n, _, _ in spans if n.startswith("train.")]
    assert top == ["train.forward", "train.backward", "train.optimizer"]
    assert _inside(spans, "train.forward") == [STAGES]
    assert _inside(spans, "train.optimizer") == [[]]


def test_exported_serving_program_holds_no_profiler_op():
    _, model = _model()
    model.eval()
    ep = export_program(model, model.state_dict(), 1, (H, W))
    targets = [str(node.target) for node in ep.graph.nodes
               if node.op == "call_function"]
    assert any("fsod" in t for t in targets)  # the traced kernels' operators
    assert not [t for t in targets
                if "profiler" in t or "record_function" in t]
