"""Single-image and batched prediction: DefaultPredictor
(ref defrcn/engine/defaults.py:131-192), counterpart of the JAX package's
``engine/predictor.py``.

The predictor runs on ``cfg.MODEL.DEVICE`` ("cuda" by default) unless the
caller passes ``device``; it raises when that device is CUDA and CUDA is
absent. There is no silent move to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..checkpoint.convert import init_weights
from ..checkpoint.torch_import import maybe_load_reference_weights
from ..data.mapper import pick_bucket, resize_shortest_edge_size
from ..models import build_model
from ..parallel.mesh import get_world_size
from ..parallel.spatial import STRIDE, band_modules
from ..structures import ImageBatch


def preprocess_single_image(cfg, original_image: np.ndarray,
                            buckets=None) -> ImageBatch:
    """BGR HxWx3 uint8 -> batch-1 ``ImageBatch`` of CPU tensors: resize the
    shortest edge (PIL bilinear, as the JAX package), hand the model
    ``cfg.INPUT.FORMAT``, zero-pad to the smallest covering bucket."""
    h0, w0 = original_image.shape[:2]
    h, w = resize_shortest_edge_size(
        h0, w0, cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST
    )
    rgb = np.ascontiguousarray(original_image[:, :, ::-1].astype(np.uint8))
    if (h, w) != (h0, w0):
        from PIL import Image

        # PIL resizes in RGB; at the original size it would copy unchanged
        rgb = np.asarray(
            Image.fromarray(rgb).resize((w, h), Image.BILINEAR), np.uint8)
    arr = rgb[:, :, ::-1] if cfg.INPUT.FORMAT == "BGR" else rgb
    bh, bw = pick_bucket(h, w, buckets or cfg.TPU.IMAGE_BUCKETS)
    padded = np.zeros((1, bh, bw, 3), np.uint8)
    padded[0, :h, :w] = arr
    return ImageBatch(
        image=torch.from_numpy(padded),
        hw=torch.tensor([[h, w]], dtype=torch.int32),
        orig_hw=torch.tensor([[h0, w0]], dtype=torch.int32),
    )


def resolve_device(cfg, device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else
    ``cfg.MODEL.DEVICE``; raises for CUDA when CUDA is absent."""
    dev = torch.device(device if device is not None else cfg.MODEL.DEVICE)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} asked for, but CUDA is not available; "
            "pass device='cpu' (MODEL.DEVICE cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise NotImplementedError(f"DefaultPredictor on {dev}")
    return dev


def spatial_devices(cfg, device: torch.device):
    """The devices of the backbone's row bands under
    ``TPU.SPATIAL_PARTITION`` S > 1 (None at S 1): on CUDA S visible cards
    from ``device`` on, on the CPU S bands on the CPU. Refuses, as the JAX
    package does, a run of more than one process and fewer devices than S,
    and more bands than res4 rows in the smallest bucket."""
    sp = cfg.TPU.SPATIAL_PARTITION
    if sp <= 1:
        return None
    if get_world_size() > 1:
        raise ValueError("TPU.SPATIAL_PARTITION is single-process only "
                         "(detections are fetched to this process)")
    rows = min(-(-min(b) // STRIDE) for b in cfg.TPU.IMAGE_BUCKETS)
    if sp > rows:
        raise ValueError(f"TPU.SPATIAL_PARTITION {sp}: the smallest bucket "
                         f"has {rows} res4 rows, fewer than the bands")
    if device.type == "cpu":
        return [device] * sp
    first = torch.cuda.current_device() if device.index is None \
        else device.index
    have = torch.cuda.device_count() - first
    if have < sp:
        raise ValueError(f"TPU.SPATIAL_PARTITION {sp} needs {sp} devices, "
                         f"have {have}")
    return [torch.device("cuda", first + i) for i in range(sp)]


class DefaultPredictor:
    """cfg -> model + weights; ``__call__(image BGR HxWx3 uint8)`` -> dict
    of numpy detections in original-image coordinates.

    ``state_dict``: this package's (detectron2-named) weights, for example
    from ``checkpoint.state_dict_from_jax_params``. Without it the model
    gets the JAX package's initialisers drawn from ``seed``, then
    ``MODEL.WEIGHTS`` when it names a file (``.pkl``, ``.pth``, ``.ckpt``).

    ``TPU.SPATIAL_PARTITION`` S > 1 runs each image's backbone in S row
    bands, one a device of ``spatial_devices`` (``parallel/spatial.py``),
    in ``__call__`` and ``predict_batch`` alike; the rest of the model runs
    on ``device``.
    """

    # batch sizes predict_batch runs at (images padded up to the next one)
    BATCH_SIZES = (1, 2, 4, 8)

    def __init__(self, cfg, device=None, state_dict=None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(cfg, device)
        devices = spatial_devices(cfg, self.device)
        model = build_model(cfg)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            init_weights(model, torch.Generator().manual_seed(seed))
            maybe_load_reference_weights(cfg.MODEL.WEIGHTS, model)
        self.model = model.to(self.device).eval()
        if devices is not None:
            # the other bands' copies of the backbone, made once here
            band_modules(self.model.backbone, devices)
            self.model.spatial_devices = devices

    @torch.inference_mode()
    def _run(self, batch: ImageBatch):
        det = self.model.forward_inference(batch.to(self.device))
        return tuple(t.cpu().numpy() for t in
                     (det.boxes, det.scores, det.classes, det.valid))

    def __call__(self, original_image: np.ndarray):
        boxes, scores, classes, valid = self._run(
            preprocess_single_image(self.cfg, original_image))
        v = valid[0]
        return {"boxes": boxes[0][v], "scores": scores[0][v],
                "classes": classes[0][v]}

    def predict_batch(self, original_images):
        """Batched ``__call__``: images sharing a padded bucket run as one
        batch, padded up to the next ``BATCH_SIZES`` entry."""
        return run_grouped(
            [preprocess_single_image(self.cfg, im) for im in original_images],
            lambda shape: self.BATCH_SIZES,
            self._run,
        )


def run_grouped(pre, sizes_fn, run):
    """Shared batching core: ``pre`` holds a batch-1 ``ImageBatch`` per
    request; ``sizes_fn(padded_shape)`` gives ascending batch sizes;
    ``run(ImageBatch)`` -> numpy (boxes, scores, classes, valid). Chunks
    each bucket group to the largest size, pads to the smallest size >= n
    with copies of the last row, and returns per-request dicts in input
    order."""
    groups = {}
    for i, b in enumerate(pre):
        groups.setdefault(tuple(b.image.shape[1:]), []).append(i)
    results = [None] * len(pre)
    for shape, idxs in groups.items():
        sizes = tuple(sizes_fn(shape))
        for start in range(0, len(idxs), sizes[-1]):
            chunk = idxs[start : start + sizes[-1]]
            n = len(chunk)
            m = next(s for s in sizes if s >= n)
            rows = chunk + [chunk[-1]] * (m - n)
            batch = ImageBatch(
                image=torch.cat([pre[i].image for i in rows]),
                hw=torch.cat([pre[i].hw for i in rows]),
                orig_hw=torch.cat([pre[i].orig_hw for i in rows]),
            )
            boxes, scores, classes, valid = run(batch)
            for j, i in enumerate(chunk):
                v = valid[j]
                results[i] = {"boxes": boxes[j][v], "scores": scores[j][v],
                              "classes": classes[j][v]}
    return results
