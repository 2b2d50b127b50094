"""Inference over a test loader, counterpart of the JAX package's
``evaluation/evaluator.py`` (ref defrcn/evaluation/evaluator.py:82-162).

Batches reach the model's device through ``device_batches`` (on CUDA,
copies on their own stream from page-locked memory); a raw batch of the
device-preprocessing loader (TPU.DEVICE_PREPROCESS) is resized there. The model runs under
``torch.inference_mode()``; each batch's detections come to the host in one
copy per field, and the padded tail of a bucket group
(``meta['valid_count']``) is dropped before the evaluator sees it. Timing
follows the reference: the first ``NUM_WARMUP`` batches are left out of the
per-image compute time, which is logged and kept, with the image count,
the wall time and PCB's time, in ``inference_on_dataset.last_timing``.
Under ``torch.profiler`` each batch's stages are spans (``utils/tracing.py``):
``eval.fetch`` (the next batch and its copies), ``eval.forward`` (the
forward enqueued), ``eval.to_host`` (the detections' copies, where the host
waits for the batch's device work), ``eval.pcb`` and ``eval.collect``.

With ``pcb`` (a ``PrototypicalCalibrationBlock``), each batch's host
detections, in original-image coordinates, are rescored with the batch's
``file_names`` before the evaluator sees them.

The painting meta-archs (``eval_gt_role`` "paint": the Semantic and Text
families) get each batch's test-time GT, as the reference's evaluation
hands it to them (GT-leaky by design, PARITY #12); every other arch sees
none. ``no_gt`` (TEST.NO_GT_EVAL) withholds it, so the Text family
evaluates its serving path (an all-background map); the Semantic family
refuses it, since its detection features are solely the painted map.

Under a process group the batches go round-robin: batch k is rank
``k % world``'s (a sharded loader hands the others a ``skip`` sentinel and
never decodes them), the owner runs it whole (PCB included), and every
rank all-gathers each batch's detections in lockstep (a foreign batch
gathers None), so every image reaches the evaluator once on every rank
and every rank reports the same metrics (the JAX package's
``evaluation/evaluator.py``, ref comm.gather). Whole batches, because GT-fed
teachers and the painting meta-archs compute across a batch.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Optional

import torch

from ..data.device_preprocess import preprocess_batch
from ..data.loader import device_batches
from ..parallel import allgather_pyobj, get_rank, get_world_size
from ..utils.tracing import span

logger = logging.getLogger(__name__)

NUM_WARMUP = 5


class DatasetEvaluator:
    def reset(self):
        pass

    def process_detections(self, image_ids, boxes, scores, classes, valid):
        raise NotImplementedError

    def evaluate(self):
        raise NotImplementedError


def inference_on_dataset(model, data_loader, evaluator: Optional[
        DatasetEvaluator], pcb=None, no_gt: bool = False):
    """Run ``model.forward_inference`` over the loader's batches on the
    model's device, rescore with ``pcb`` when given, and return
    ``evaluator.evaluate()`` ({} without one). A painting arch gets the
    batch's GT unless ``no_gt``. Logs the image count, the per-image
    compute time without the warm-up batches, and the per-image wall
    time."""
    role = getattr(model, "eval_gt_role", "teacher")
    if no_gt and role == "paint" and getattr(
            model, "paint_replaces_features", False):
        raise ValueError(
            "TEST.NO_GT_EVAL is not meaningful for "
            f"{type(model).__name__}: its detection features are solely "
            "the painted semantic map, so withholding GT evaluates a "
            "constant feature map. Use the Text family for a serving-path "
            "evaluation, or drop TEST.NO_GT_EVAL.")
    feed_gt = not no_gt and role == "paint"
    if evaluator is not None:
        evaluator.reset()
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    start = time.perf_counter()
    steady_start, steady_images, num_images = None, 0, 0
    pcb_s = 0.0
    world, rank = get_world_size(), get_rank()
    batches = device_batches(data_loader, device)
    try:
        with torch.inference_mode():
            for k in itertools.count():
                with span("eval.fetch"):
                    batch = next(batches, None)
                if batch is None:
                    break
                images, gt, meta = batch
                entry = None
                # a plain loader's batch of another rank is skipped too
                if images is not None and k % world == rank:
                    entry, secs = _run_batch(model, images, gt, meta,
                                             feed_gt, pcb)
                    pcb_s += secs
                with span("eval.collect"):
                    for got in allgather_pyobj(entry):
                        if got is None:
                            continue
                        ids, fields = got
                        num_images += len(ids)
                        if steady_start is not None:
                            steady_images += len(ids)
                        if evaluator is not None:
                            evaluator.process_detections(ids, *fields)
                if k + 1 == NUM_WARMUP:
                    steady_start = time.perf_counter()
    finally:
        batches.close()
        model.train(was_training)
    wall = time.perf_counter() - start
    steady = ((time.perf_counter() - steady_start) / steady_images
              if steady_images else wall / max(num_images, 1))
    inference_on_dataset.last_timing = dict(
        images=num_images, timed_images=steady_images,
        s_per_image=steady, wall_s_per_image=wall / max(num_images, 1),
        pcb_s=pcb_s)
    logger.info(
        "Inference done: %d images, %.4f s/img compute (warmup-skipped), "
        "%.4f s/img wall", num_images, steady, wall / max(num_images, 1),
    )
    if evaluator is None:
        return {}
    return evaluator.evaluate()


def _run_batch(model, images, gt, meta, feed_gt: bool, pcb):
    """One batch's (image ids, [boxes, scores, classes, valid] on the host)
    without the padded tail, rescored by ``pcb``; and PCB's seconds."""
    with span("eval.forward"):
        if "target_hw" in meta:  # TPU.DEVICE_PREPROCESS
            images = preprocess_batch(images, meta)
        det = model.forward_inference(images, gt if feed_gt else None)
    n = meta.get("valid_count", images.image.shape[0])
    with span("eval.to_host"):
        fields = [t[:n].cpu().numpy() for t in
                  (det.boxes, det.scores, det.classes, det.valid)]
    ids = list(meta.get("image_ids", list(range(n)))[:n])
    if pcb is None:
        return (ids, fields), 0.0
    t0 = time.perf_counter()
    names = meta.get("file_names")
    with span("eval.pcb"):
        det_np = pcb.execute_calibration(
            ids, dict(zip(("boxes", "scores", "classes", "valid"), fields)),
            file_names=None if names is None else names[:n])
    fields = [det_np[k] for k in ("boxes", "scores", "classes", "valid")]
    return (ids, fields), time.perf_counter() - t0


# the latest run's {images, timed_images, s_per_image (warm-up left out),
# wall_s_per_image, pcb_s (seconds in execute_calibration)}
inference_on_dataset.last_timing = None
