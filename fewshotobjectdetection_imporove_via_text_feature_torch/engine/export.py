"""Serving export: one ``torch.export`` program per (batch, padded bucket),
bundled with the weights, and ``ServingPredictor`` over it.

Counterpart of the JAX package's ``engine/export.py``. A serving host loads
the artifact and calls it without building the model: each program is the
model's ``forward_inference`` on ``(image, hw, orig_hw) -> (boxes, scores,
classes, valid)``, traced through the ``fsod::`` operators
(``ops/custom_ops.py``), so a program run on the card launches the
hand-written NMS and ROIAlign kernels and the same program on the CPU runs
their plain versions. The weights are an input of every program (a
``torch.func.functional_call`` over the state dict), so the artifact stores
them once.

Artifact layout (one zip):
    meta.json                  the input contract (buckets, batches, format,
                               resize bounds, device, compute dtype)
    weights.pt                 the state dict, ``torch.load(weights_only=True)``
    programs/{B}x{H}x{W}.pt2   ``torch.export.save`` of each program

A program is traced for one device type (``meta["device"]``): factory
calls and the operators' output layouts are fixed at trace time, so an
artifact serves on the device it was exported for. The port's artifacts
and the JAX package's ``.shlo`` artifacts are not interchangeable.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models import build_model
from ..structures import ImageBatch
from .predictor import preprocess_single_image, resolve_device, run_grouped

FORMAT = "fsodtf-torch-export-1"
_PROGRAM_DIR = "programs"


def bucket_shapes(buckets) -> Sequence[Tuple[int, int]]:
    """Distinct padded shapes a predictor can emit: every bucket in both
    orientations (``pick_bucket`` considers (a, b) and (b, a))."""
    shapes = []
    for bh, bw in buckets:
        for shape in ((int(bh), int(bw)), (int(bw), int(bh))):
            if shape not in shapes:
                shapes.append(shape)
    return shapes


class _ServingProgram(nn.Module):
    """``(state, image, hw, orig_hw) -> (boxes, scores, classes, valid)``
    of ``model`` with ``state`` swapped in for its weights. The model is
    held outside the module tree, so the export lifts none of its weights
    into the program."""

    def __init__(self, model):
        super().__init__()
        self._model = (model,)

    def forward(self, state, image, hw, orig_hw):
        det = torch.func.functional_call(
            self._model[0], state, (ImageBatch(image, hw, orig_hw),))
        return det.boxes, det.scores, det.classes, det.valid


def export_program(model, state, batch: int, shape: Tuple[int, int]):
    """The ``torch.export`` program of ``model`` (in eval mode, on its
    device) at ``batch`` images of the padded ``shape``; ``state`` is the
    model's state dict on that device."""
    # a plain dict: the program checks its input's structure, and an
    # OrderedDict (what ``state_dict()`` returns) is another structure
    state = dict(state)
    dev = next(iter(state.values())).device
    bh, bw = shape
    image = torch.zeros((batch, bh, bw, 3), dtype=torch.uint8, device=dev)
    hw = torch.tensor([[bh, bw]] * batch, dtype=torch.int32, device=dev)
    # hw and orig_hw must be distinct tensors: the tracer makes one input of
    # two arguments that are the same tensor. Traced without autograd, the
    # frozen stages' own no_grad leaves no grad-mode region in the graph.
    with torch.no_grad():
        ep = torch.export.export(_ServingProgram(model),
                                 (state, image, hw, hw.clone()),
                                 strict=False)
    ep.example_inputs = None  # the weights would be saved with each program
    return ep


def serving_meta(cfg, batches, shapes, device) -> dict:
    """``meta.json``: the JAX package's keys, ``torch_version`` in place of
    ``jax_version``, and the device type and compute dtype traced."""
    min_size = cfg.INPUT.MIN_SIZE_TEST
    if isinstance(min_size, (list, tuple)):
        min_size = min_size[0]
    meta = {
        "format": FORMAT,
        "batch": min(batches),
        "batches": sorted(batches),
        "buckets": [list(s) for s in shapes],
        "input_format": cfg.INPUT.FORMAT,
        "min_size_test": int(min_size),
        "max_size_test": int(cfg.INPUT.MAX_SIZE_TEST),
        "num_classes": int(cfg.MODEL.ROI_HEADS.NUM_CLASSES),
        "device": torch.device(device).type,
        "compute_dtype": cfg.TPU.COMPUTE_DTYPE,
        "torch_version": torch.__version__,
    }
    from ..utils.class_name import get_class_name

    try:  # a label map for serving responses, when the config resolves one
        meta["class_names"] = list(get_class_name(cfg))
    except (ValueError, KeyError, IndexError):
        pass
    return meta


def export_inference(cfg, state_dict, batch=1,
                     buckets: Optional[Sequence[Tuple[int, int]]] = None,
                     device=None):
    """Export the inference program of every (batch size, bucket shape).

    ``batch`` is an int or a sequence of ints; ``buckets`` defaults to
    ``cfg.TPU.IMAGE_BUCKETS``, each in both orientations. The programs are
    traced on ``device`` (``cfg.MODEL.DEVICE`` by default; CUDA raises
    when absent) and serve there. Returns (meta, {(b, h, w):
    ExportedProgram}).
    """
    if cfg.TPU.SPATIAL_PARTITION > 1:
        raise ValueError(
            "TPU.SPATIAL_PARTITION is not exportable: an exported program "
            "runs on one device")
    dev = resolve_device(cfg, device)
    model = build_model(cfg)
    model.load_state_dict(state_dict)
    model = model.to(dev).eval()
    state = {k: v.to(dev) for k, v in model.state_dict().items()}
    shapes = bucket_shapes(buckets or cfg.TPU.IMAGE_BUCKETS)
    batches = sorted({int(b) for b in
                      (batch if isinstance(batch, (list, tuple)) else [batch])})
    programs = {}
    for b in batches:
        for shape in shapes:
            programs[(b, *shape)] = export_program(model, state, b, shape)
    return serving_meta(cfg, batches, shapes, dev), programs


def save_serving_artifact(path: str, meta: dict, programs: dict,
                          state_dict) -> None:
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=1))
        buf = io.BytesIO()
        torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, buf)
        z.writestr("weights.pt", buf.getvalue())
        for (b, bh, bw), ep in programs.items():
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            z.writestr(f"{_PROGRAM_DIR}/{b}x{bh}x{bw}.pt2", buf.getvalue())


def load_serving_artifact(path: str):
    """-> (meta, state dict of CPU tensors, {(b, h, w): ExportedProgram})."""
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("format") != FORMAT:
            raise ValueError(
                f"{path}: not a serving artifact of this package (format "
                f"{meta.get('format')!r}, expected {FORMAT!r}); the JAX "
                "package's artifacts do not load here")
        state = torch.load(io.BytesIO(z.read("weights.pt")),
                           weights_only=True)
        programs = {}
        for name in z.namelist():
            if name.startswith(_PROGRAM_DIR + "/") and name.endswith(".pt2"):
                b, bh, bw = name[len(_PROGRAM_DIR) + 1: -4].split("x")
                programs[(int(b), int(bh), int(bw))] = torch.export.load(
                    io.BytesIO(z.read(name)))
    return meta, state, programs


class _InputCfg:
    """The config view ``preprocess_single_image`` reads, from meta.json."""

    def __init__(self, meta):
        class _Input:
            MIN_SIZE_TEST = meta["min_size_test"]
            MAX_SIZE_TEST = meta["max_size_test"]
            FORMAT = meta["input_format"]

        class _TPU:
            IMAGE_BUCKETS = [tuple(b) for b in meta["buckets"]]

        self.INPUT = _Input
        self.TPU = _TPU


class ServingPredictor:
    """``DefaultPredictor``'s API over a serving artifact: no model build,
    no config file, no checkpoint load. Runs on ``device`` (CUDA unless the
    caller asks for the CPU; CUDA raises when absent), which must be the
    device type the artifact was exported for."""

    def __init__(self, artifact_path: str, device=None):
        self.meta, state, programs = load_serving_artifact(artifact_path)
        self.device = resolve_device(None, device or "cuda")
        if self.meta["device"] != self.device.type:
            raise ValueError(
                f"{artifact_path} was exported for {self.meta['device']!r}, "
                f"not {self.device.type!r}; re-export on the serving device")
        if 1 not in self.meta["batches"]:
            raise ValueError(
                "single-image ServingPredictor needs a batch-1 artifact; "
                f"this one was exported at batches {self.meta['batches']}")
        self._state = {k: v.to(self.device) for k, v in state.items()}
        self._programs: Dict[tuple, nn.Module] = {
            k: ep.module() for k, ep in programs.items()}
        self._cfg = _InputCfg(self.meta)

    def _program_for(self, image_shape, batch: int):
        """Padded image shape (H, W, 3) and batch size -> the program, or
        a contract error naming what is missing."""
        key = (batch, *image_shape[:2])
        if key not in self._programs:
            raise ValueError(
                f"no exported program for padded bucket "
                f"{tuple(image_shape[:2])} at batch {batch}; the artifact "
                f"contains {sorted(self._programs)}: re-export with "
                "covering TPU.IMAGE_BUCKETS / --batches")
        return self._programs[key]

    @torch.inference_mode()
    def _run(self, batch: ImageBatch):
        program = self._program_for(batch.image.shape[1:],
                                    batch.image.shape[0])
        b = batch.to(self.device)
        out = program(self._state, b.image, b.hw, b.orig_hw)
        return tuple(t.cpu().numpy() for t in out)

    def __call__(self, original_image: np.ndarray):
        boxes, scores, classes, valid = self._run(
            preprocess_single_image(self._cfg, original_image))
        v = valid[0]
        return {"boxes": boxes[0][v], "scores": scores[0][v],
                "classes": classes[0][v]}

    def predict_batch(self, original_images):
        """Batched serving: requests group by padded bucket and run at the
        smallest exported batch size that fits (rows padded with copies of
        the last). An artifact of batch-1 programs runs each alone."""
        pre = [preprocess_single_image(self._cfg, im)
               for im in original_images]

        def sizes_fn(shape):
            sizes = sorted(b for (b, bh, bw) in self._programs
                           if (bh, bw) == tuple(shape[:2]))
            return sizes or (1,)  # _program_for raises the contract error

        return run_grouped(pre, sizes_fn, self._run)
