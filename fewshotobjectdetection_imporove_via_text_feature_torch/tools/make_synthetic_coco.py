"""Write a synthetic COCO tree in the few-shot ``cocosplit`` layout, made from
a seed, for workflow runs without a download:

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_coco \\
        --root DIR [--train-images 32] [--test-images 64] [--shots 1] \\
        [--seeds 0] [--image-size 640 480]

Under DIR: ``coco/trainval2014`` and ``coco/val2014`` JPEGs (a smooth
colour field with rectangles, as ``make_synthetic_voc --image-size``
writes), ``cocosplit/datasplit/trainvalno5k.json`` and ``5k.json`` (COCO
json: XYWH boxes, ``area``, ``iscrowd`` 0), and for each seed, shot and
class ``cocosplit/seed{S}/full_box_{K}shot_{name}_trainval.json`` holding
the first K trainval images with that class and their boxes of it. Image i
holds three boxes whose categories rotate through the 80 COCO classes, so
32 trainval images cover every class.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.builtin_meta import COCO_THING_CATEGORIES
from .make_synthetic_voc import _photo_like


def _images(rng, img_dir, prefix, n, start_id, size, first_cat):
    from PIL import Image

    os.makedirs(img_dir, exist_ok=True)
    w, h = size
    images, annotations = [], []
    for i in range(n):
        image_id = start_id + i
        fname = f"COCO_{prefix}_{image_id:012d}.jpg"
        Image.fromarray(_photo_like(rng, h, w)).save(
            os.path.join(img_dir, fname))
        images.append({"id": image_id, "file_name": fname, "height": h,
                       "width": w})
        for k in range(3):
            cat = COCO_THING_CATEGORIES[(first_cat + 3 * i + k)
                                        % len(COCO_THING_CATEGORIES)][0]
            bw, bh = w * (0.2 + 0.1 * k), h * (0.25 + 0.1 * k)
            x, y = w * 0.05 + k * w * 0.25, h * 0.05 + k * h * 0.2
            annotations.append({
                "id": image_id * 10 + k, "image_id": image_id,
                "category_id": cat, "bbox": [x, y, bw, bh],
                "area": bw * bh, "iscrowd": 0})
    return images, annotations


def _write(path, images, annotations):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cats = [{"id": i, "name": n} for i, n in COCO_THING_CATEGORIES]
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": cats}, f)


def make_coco(root: str, train_images: int = 32, test_images: int = 64,
              shots=(1,), seeds=(0,), image_size=(640, 480)) -> None:
    rng = np.random.RandomState(0)
    train, train_anns = _images(
        rng, os.path.join(root, "coco", "trainval2014"), "train2014",
        train_images, 1, image_size, 0)
    test, test_anns = _images(
        rng, os.path.join(root, "coco", "val2014"), "val2014", test_images,
        1 + train_images, image_size, 1)
    split = os.path.join(root, "cocosplit", "datasplit")
    _write(os.path.join(split, "trainvalno5k.json"), train, train_anns)
    _write(os.path.join(split, "5k.json"), test, test_anns)
    by_id = {img["id"]: img for img in train}
    for seed in seeds:
        for shot in shots:
            for cat, name in COCO_THING_CATEGORIES:
                anns = [a for a in train_anns if a["category_id"] == cat]
                ids = list(dict.fromkeys(a["image_id"] for a in anns))[:shot]
                _write(os.path.join(
                    root, "cocosplit", f"seed{seed}",
                    f"full_box_{shot}shot_{name}_trainval.json"),
                    [by_id[i] for i in ids],
                    [a for a in anns if a["image_id"] in ids])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="datasets")
    p.add_argument("--train-images", type=int, default=32)
    p.add_argument("--test-images", type=int, default=64)
    p.add_argument("--shots", type=int, nargs="+", default=[1])
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--image-size", type=int, nargs=2, default=[640, 480],
                   metavar=("W", "H"))
    args = p.parse_args(argv)
    make_coco(args.root, args.train_images, args.test_images, args.shots,
              args.seeds, tuple(args.image_size))
    print(f"synthetic COCO + {args.shots}-shot splits under {args.root}")


if __name__ == "__main__":
    main()
