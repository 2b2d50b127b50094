"""Evaluation images/s by batch size, on one card: the measurement behind
``cli.EVAL_BATCH_SIZE``.

    python3 -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.eval_batch_sweep \\
        [--images 800] [--sizes 8 16 32] [--config-file FILE] [--opts KEY VALUE ...]

Makes synthetic VOC in a temporary directory (``--images`` JPEGs of
500x375, the VOC size, a year), builds the config's model on seeded
weights in bf16 and evaluates the config's first test set with the CLI's
evaluator at each batch size, in turns (the sizes up, then down). Each rate
leaves out the first 5 batches, as ``inference_on_dataset`` times them; 800
images make 25 batches of 32, so every default size has at least 20 timed
batches. Prints a line a run and, last, a JSON object with each size's
images/s (the mean of its two turns), timed batches and peak memory.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from .. import cli
from ..data import build_detection_test_loader, register_all
from ..evaluation import inference_on_dataset
from .make_synthetic_voc import make_voc

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "configs", "voc", "defrcn_det_r101_base1.yaml")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--images", type=int, default=800)
    p.add_argument("--sizes", type=int, nargs="+", default=[8, 16, 32])
    p.add_argument("--config-file", default=os.path.normpath(CONFIG))
    p.add_argument("--opts", default=[], nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(["MODEL.WEIGHTS", "", "TPU.COMPUTE_DTYPE",
                         "bfloat16", *args.opts])
    name = cfg.DATASETS.TEST[0]
    model = cli.build_test_model(cfg)
    pin = next(model.parameters()).is_cuda
    runs = {s: [] for s in args.sizes}
    info = {}
    with tempfile.TemporaryDirectory() as tmp:
        make_voc(tmp, images=args.images, image_size=(500, 375))
        register_all(tmp)
        for size in [*args.sizes, *reversed(args.sizes)]:
            torch.cuda.reset_peak_memory_stats()
            inference_on_dataset(model, build_detection_test_loader(
                cfg, name, batch_size=size, pin_memory=pin),
                cli.build_evaluator(cfg, name, tmp))
            t = inference_on_dataset.last_timing
            peak = torch.cuda.max_memory_allocated() / 2**30
            runs[size].append(1 / t["s_per_image"])
            info[size] = dict(timed_batches=t["timed_images"] // size,
                              peak_gib=max(peak, info.get(size, {}).get(
                                  "peak_gib", 0.0)))
            print(f"batch {size}: {1 / t['s_per_image']:.2f} images/s over "
                  f"{t['timed_images'] // size} timed batches of "
                  f"{-(-t['images'] // size)}, peak {peak:.2f} GiB",
                  flush=True)
    print(f"{torch.cuda.get_device_name(0)}, {cfg.MODEL.RESNETS.DEPTH} "
          f"layers, {cfg.MODEL.ROI_HEADS.NUM_CLASSES} classes, {name}, "
          f"{args.images} images")
    print(json.dumps({str(s): dict(images_per_s=sum(r) / len(r), turns=r,
                                   **info[s]) for s, r in runs.items()}))


if __name__ == "__main__":
    main()
