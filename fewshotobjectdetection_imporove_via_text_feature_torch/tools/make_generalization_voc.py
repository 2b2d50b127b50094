"""Write a learnable synthetic Pascal VOC tree with disjoint train and
held-out splits, and its k-shot split files, made from a seed:

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_generalization_voc \\
        --root DIR [--train-2007 120] [--train-2012 60] [--val 60] \\
        [--shots 10] [--seed 0] [--rng-seed 20260820]

Counterpart of the repository's ``tools/_make_generalization_voc.py``, with
the same files for the same arguments:

  * split 1's 20 VOC classes <-> 20 distinct solid colours (a hue wheel
    with alternating brightness, so neighbours stay separable);
  * a mid-grey background with mild noise;
  * 1-3 objects an image at random positions and sizes, little overlap;
  * VOC2007 trainval + VOC2012 trainval are the train pool, VOC2007 test
    the held-out images (disjoint ids, same distribution); VOC2012 ids
    carry an underscore, as real ones do, which the k-shot loader reads;
  * ``vocsplit/seed{S}/box_{K}shot_{cls}_train.txt`` drawn from the train
    images only, in the reference's format.
"""

from __future__ import annotations

import argparse
import colorsys
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

W, H = 320, 240


def class_colors(classes):
    """Separable colours: a hue wheel, the value alternating so that
    adjacent hues differ in brightness too."""
    colors = {}
    for i, c in enumerate(classes):
        r, g, b = colorsys.hsv_to_rgb(
            i / len(classes), 0.95, 0.95 if i % 2 == 0 else 0.55
        )
        colors[c] = (int(r * 255), int(g * 255), int(b * 255))
    return colors


def _background(rng):
    """Mid-grey with mild noise (full-range noise drowns the tiny model's
    objectness)."""
    return np.clip(
        128 + rng.randint(-12, 13, (H, W, 3)), 0, 255
    ).astype(np.uint8)


def _patch(rng, rgb, bh, bw):
    """A solid colour with light noise: the class signal is the mean."""
    r, g, b = rgb
    patch = np.stack(
        [
            np.full((bh, bw), r, np.int16),
            np.full((bh, bw), g, np.int16),
            np.full((bh, bw), b, np.int16),
        ],
        axis=-1,
    )
    return np.clip(patch + rng.randint(-18, 19, patch.shape), 0,
                   255).astype(np.uint8)


def _place_objects(rng, classes, colors, n_obj):
    """Random rectangles overlapping each other by at most 10%; returns
    (image uint8, [(name, x1, y1, x2, y2)])."""
    img = _background(rng)
    placed = []
    for _ in range(n_obj):
        for _try in range(8):
            bw = int(rng.randint(50, 110))
            bh = int(rng.randint(50, 110))
            x1 = int(rng.randint(0, W - bw))
            y1 = int(rng.randint(0, H - bh))
            box = (x1, y1, x1 + bw, y1 + bh)
            ok = True
            for _, px1, py1, px2, py2 in placed:
                ix = max(0, min(box[2], px2) - max(box[0], px1))
                iy = max(0, min(box[3], py2) - max(box[1], py1))
                if ix * iy > 0.1 * bw * bh:
                    ok = False
                    break
            if ok:
                break
        else:
            continue
        name = classes[int(rng.randint(len(classes)))]
        img[y1 : y1 + bh, x1 : x1 + bw] = _patch(rng, colors[name], bh, bw)
        placed.append((name, *box))
    return img, placed


def _render_all(rng, placed, colors):
    """A merged object list on a fresh canvas, overlaps beyond 10% left
    out."""
    img = _background(rng)
    kept = []
    for name, x1, y1, x2, y2 in placed:
        ok = True
        for _, px1, py1, px2, py2 in kept:
            ix = max(0, min(x2, px2) - max(x1, px1))
            iy = max(0, min(y2, py2) - max(y1, py1))
            if ix * iy > 0.1 * (x2 - x1) * (y2 - y1):
                ok = False
                break
        if not ok:
            continue
        img[y1:y2, x1:x2] = _patch(rng, colors[name], y2 - y1, x2 - x1)
        kept.append((name, x1, y1, x2, y2))
    return img, kept


def _write_image(d, fid, img, placed):
    from PIL import Image

    objs = "".join(
        OBJ.format(name=n, x1=x1 + 1, y1=y1 + 1, x2=x2, y2=y2)
        for n, x1, y1, x2, y2 in placed
    )
    with open(os.path.join(d, "Annotations", fid + ".xml"), "w") as f:
        f.write(XML.format(w=W, h=H, objs=objs))
    Image.fromarray(img).save(
        os.path.join(d, "JPEGImages", fid + ".jpg"), quality=92
    )


def make_generalization_voc(root, train_2007=120, train_2012=60, val=60,
                            shots=(10,), seeds=(0,), rng_seed=20260820):
    """Write the tree under ``root``; raises ValueError when a class has
    fewer train images than the largest shot."""
    classes = list(PASCAL_VOC_ALL_CATEGORIES[1])
    colors = class_colors(classes)
    rng = np.random.RandomState(rng_seed)

    # class -> [(year, fid)] over the train images (for the k-shot files)
    by_class = {c: [] for c in classes}
    counts = {
        ("2007", "trainval"): train_2007,
        ("2012", "trainval"): train_2012,
        ("2007", "test"): val,
    }
    fid_counter = 0
    train_idx = 0  # across years: the round-robin covers every class
    for (year, split), n in counts.items():
        d = os.path.join(root, f"VOC{year}")
        for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        ids = []
        for _ in range(n):
            fid = (
                f"{fid_counter:06d}" if year == "2007"
                else f"2012_{fid_counter:06d}"
            )
            fid_counter += 1
            ids.append(fid)
            # the first two passes through the classes are round-robin, so
            # that every class has train instances for the k-shot files
            if split == "trainval" and train_idx < len(classes) * 2:
                forced = classes[train_idx % len(classes)]
                img, placed = _place_objects(rng, [forced], colors, n_obj=1)
                extra_n = int(rng.randint(0, 3))
                if extra_n:
                    _, placed2 = _place_objects(rng, classes, colors,
                                                n_obj=extra_n)
                    img, placed = _render_all(rng, placed + placed2, colors)
            else:
                img, placed = _place_objects(
                    rng, classes, colors, n_obj=int(rng.randint(1, 4))
                )
            if not placed:  # keep ids and files aligned
                img, placed = _place_objects(rng, classes, colors, 1)
            _write_image(d, fid, img, placed)
            if split == "trainval":
                train_idx += 1
                seen = set()
                for name, *_ in placed:
                    if name not in seen:
                        by_class[name].append((year, fid))
                        seen.add(name)
        with open(
            os.path.join(d, "ImageSets", "Main", split + ".txt"), "w"
        ) as f:
            f.write("\n".join(ids) + "\n")

    short = {c: len(v) for c, v in by_class.items() if len(v) < max(shots)}
    if short:
        raise ValueError(f"classes with too few train images: {short}")

    for seed in seeds:
        sd = os.path.join(root, "vocsplit", f"seed{seed}")
        os.makedirs(sd, exist_ok=True)
        srng = np.random.RandomState(1000 + seed)
        for shot in shots:
            for cls in classes:
                pool = list(by_class[cls])
                idx = srng.permutation(len(pool))[:shot]
                fn = os.path.join(sd, f"box_{shot}shot_{cls}_train.txt")
                with open(fn, "w") as f:
                    for j in idx:
                        year, fid = pool[j]
                        f.write(f"VOC{year}/JPEGImages/{fid}.jpg\n")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--train-2007", type=int, default=120)
    p.add_argument("--train-2012", type=int, default=60)
    p.add_argument("--val", type=int, default=60)
    p.add_argument("--shots", type=int, nargs="+", default=[10])
    p.add_argument("--seed", type=int, nargs="+", default=[0])
    p.add_argument("--rng-seed", type=int, default=20260820)
    args = p.parse_args(argv)
    make_generalization_voc(args.root, args.train_2007, args.train_2012,
                            args.val, args.shots, args.seed, args.rng_seed)
    print(
        f"generalization VOC: {args.train_2007}+{args.train_2012} train, "
        f"{args.val} held-out val, shots={args.shots} under {args.root}"
    )


if __name__ == "__main__":
    main()
