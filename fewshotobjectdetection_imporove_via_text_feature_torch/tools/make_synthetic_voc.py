"""Write a synthetic Pascal VOC tree and its k-shot split files, made from a
seed, for workflow runs without a download:

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_voc \\
        --root DIR [--images 12] [--shots 1] [--seed 0] [--image-size W H]

Counterpart of the repository's ``tools/_make_synthetic_voc.py``, with the
same annotations, image sets and split files for the same arguments:
VOC2007 and VOC2012 each get ``--images`` JPEGs (ids 000000...), three
objects an image whose classes rotate through split 1's 20 classes, and
``trainval`` = ``test``; ``vocsplit/seed{S}/box_{K}shot_{cls}_train.txt``
lists the first K VOC2007 images of each class. By default image i is
(300 + 10 i) x (220 + 6 i) pixels of uniform noise, as there. With
``--image-size W H`` every image is W x H and holds a smooth colour field,
rectangles and mild noise, which compresses like a photograph (a noise JPEG
is several times larger and slower to decode).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.builtin_meta import PASCAL_VOC_ALL_CATEGORIES

XML = """<annotation>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  {objs}
</annotation>"""
OBJ = """<object>
    <name>{name}</name><difficult>0</difficult>
    <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
  </object>"""


def _photo_like(rng, h, w):
    """A smooth colour field with bright rectangles and mild noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        fy, fx = rng.uniform(0.004, 0.03, 2)
        img[..., c] = 127 + 60 * np.sin(fy * yy + fx * xx
                                        + rng.uniform(0, 6.3))
    for _ in range(6):
        y0, x0 = rng.randint(0, h - 20), rng.randint(0, w - 20)
        img[y0:y0 + rng.randint(20, h // 2),
            x0:x0 + rng.randint(20, w // 2)] = rng.uniform(0, 255, 3)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_voc(root: str, images: int = 12, shots=(1,), seeds=(0,),
             image_size=None) -> None:
    from PIL import Image

    classes = PASCAL_VOC_ALL_CATEGORIES[1]
    rng = np.random.RandomState(0)
    ids = []
    for year in ("2007", "2012"):
        d = os.path.join(root, f"VOC{year}")
        for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        year_ids = []
        for i in range(images):
            fid = f"{i:06d}"
            year_ids.append(fid)
            w, h = image_size or (300 + 10 * i, 220 + 6 * i)
            objs = ""  # 3 objects an image, classes rotate
            for k in range(3):
                cls = classes[(i * 3 + k) % len(classes)]
                x1 = 10 + 40 * k
                y1 = 15 + 30 * k
                objs += OBJ.format(name=cls, x1=x1, y1=y1, x2=x1 + 90,
                                   y2=y1 + 80)
            with open(os.path.join(d, "Annotations", fid + ".xml"), "w") as f:
                f.write(XML.format(w=w, h=h, objs=objs))
            pixels = (_photo_like(rng, h, w) if image_size else
                      rng.randint(0, 255, (h, w, 3), dtype=np.uint8))
            Image.fromarray(pixels).save(
                os.path.join(d, "JPEGImages", fid + ".jpg"))
        for split in ("trainval", "test"):
            with open(os.path.join(d, "ImageSets", "Main", split + ".txt"),
                      "w") as f:
                f.write("\n".join(year_ids))
        if year == "2007":
            ids = year_ids

    # class -> the VOC2007 images that hold it, as the split files list them
    by_class = {c: [] for c in classes}
    for i, fid in enumerate(ids):
        for k in range(3):
            by_class[classes[(i * 3 + k) % len(classes)]].append(fid)
    for seed in seeds:
        sd = os.path.join(root, "vocsplit", f"seed{seed}")
        os.makedirs(sd, exist_ok=True)
        for shot in shots:
            for cls in classes:
                fn = os.path.join(sd, f"box_{shot}shot_{cls}_train.txt")
                with open(fn, "w") as f:
                    for fid in by_class[cls][: max(shot, 1)]:
                        f.write(f"VOC2007/JPEGImages/{fid}.jpg\n")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="datasets")
    p.add_argument("--images", type=int, default=12)
    p.add_argument("--shots", type=int, nargs="+", default=[1])
    p.add_argument("--seed", type=int, nargs="+", default=[0])
    p.add_argument("--image-size", type=int, nargs=2, default=None,
                   metavar=("W", "H"))
    args = p.parse_args(argv)
    make_voc(args.root, args.images, args.shots, args.seed,
             tuple(args.image_size) if args.image_size else None)
    print(f"synthetic VOC + {args.shots}-shot splits under {args.root}")


if __name__ == "__main__":
    main()
