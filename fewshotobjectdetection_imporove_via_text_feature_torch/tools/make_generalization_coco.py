"""Write a learnable synthetic COCO-14 tree with a disjoint held-out val
split and its k-shot files, made from a seed, for the COCO held-out gate
(``check_generalization_coco.sh``):

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_generalization_coco \\
        --root DIR [--train 192] [--val 60] [--shots 10] [--seed 0] \\
        [--rng-seed 20260821]

Counterpart of the repository's ``tools/_make_generalization_coco.py``,
with the same files for the same arguments, and the COCO analog of
``make_generalization_voc.py``: class <-> solid colour (its hue wheel with
alternating brightness) on a mid-grey noisy background, so a tiny model
must learn the colour mapping and carry it to unseen images. It exercises
the contiguous id map of ``data/meta_coco.py``, the 60 -> 80 randinit
surgery, the merging of the cocosplit k-shot files and COCO's bAP/nAP.

Only the first 12 base and 4 novel categories carry instances: 80
separable colours are beyond the tiny model, and COCO's evaluation leaves
classes with no GT out of the mean. Every one of the 80 k-shot files is
still written (empty for the inactive classes), so the "all" split reads
the full layout.

Layout (defrcn/data/builtin.py:10-30, meta_coco.py:14-60):
  coco/trainval2014/*.jpg + cocosplit/datasplit/trainvalno5k.json  train
  coco/val2014/*.jpg      + cocosplit/datasplit/5k.json            held out
  cocosplit/seed{S}/full_box_{K}shot_{cls}_trainval.json           80 files
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.builtin_meta import COCO_NOVEL_IDS, COCO_THING_CATEGORIES
from .make_generalization_voc import class_colors

W, H = 320, 240


def active_categories(n_base=12, n_novel=4):
    """The first ``n_base`` base and ``n_novel`` novel categories in COCO
    id order."""
    novel_set = set(COCO_NOVEL_IDS)
    base = [(i, n) for i, n in COCO_THING_CATEGORIES if i not in novel_set]
    novel = [(i, n) for i, n in COCO_THING_CATEGORIES if i in novel_set]
    return base[:n_base], novel[:n_novel]


def _background(rng):
    return np.clip(
        128 + rng.randint(-12, 13, (H, W, 3)), 0, 255
    ).astype(np.uint8)


def _place(rng, cat_ids, colors, n_obj):
    """Coloured rectangles overlapping each other by at most 10%; returns
    (image uint8, [(cat_id, x1, y1, x2, y2)])."""
    img = _background(rng)
    placed = []
    for _ in range(n_obj):
        for _try in range(8):
            bw = int(rng.randint(50, 110))
            bh = int(rng.randint(50, 110))
            x1 = int(rng.randint(0, W - bw))
            y1 = int(rng.randint(0, H - bh))
            box = (x1, y1, x1 + bw, y1 + bh)
            if all(
                max(0, min(box[2], px2) - max(box[0], px1))
                * max(0, min(box[3], py2) - max(box[1], py1))
                <= 0.1 * bw * bh
                for _, px1, py1, px2, py2 in placed
            ):
                break
        else:
            continue
        cid = cat_ids[int(rng.randint(len(cat_ids)))]
        r, g, b = colors[cid]
        patch = np.stack(
            [np.full((bh, bw), v, np.int16) for v in (r, g, b)], axis=-1
        ) + rng.randint(-18, 19, (bh, bw, 3))
        img[y1:y1 + bh, x1:x1 + bw] = np.clip(patch, 0, 255).astype(np.uint8)
        placed.append((cid, *box))
    return img, placed


def make_generalization_coco(root, train=192, val=60, shots=(10,),
                             seeds=(0,), rng_seed=20260821):
    """Write the tree under ``root``; raises ValueError when an active
    class has fewer train images than the largest shot."""
    from PIL import Image

    base, novel = active_categories()
    active = base + novel
    active_ids = [i for i, _ in active]
    # distinct colours for the active classes, keyed by category id
    named = class_colors([n for _, n in active])
    colors = {i: named[n] for (i, n) in active}
    rng = np.random.RandomState(rng_seed)
    cats = [{"id": i, "name": n} for i, n in COCO_THING_CATEGORIES]

    by_class = {i: [] for i in active_ids}  # cat_id -> [(image, anns)]
    aid = 1

    def render_split(img_dir, ids, is_train):
        nonlocal aid
        os.makedirs(img_dir, exist_ok=True)
        images, annotations = [], []
        for k, img_id in enumerate(ids):
            if is_train:
                # one object an image: the k-shot files are per-class
                # slices, so a train image with several classes would leave
                # the others unlabelled in the merged k-shot view; the
                # round-robin gives every active class >= max(shots) images
                cid = active_ids[k % len(active_ids)]
                img, placed = _place(rng, [cid], colors, 1)
                if not placed:
                    img, placed = _place(rng, [cid], colors, 1)
            else:
                img, placed = _place(
                    rng, active_ids, colors, int(rng.randint(1, 3))
                )
                if not placed:
                    img, placed = _place(rng, active_ids, colors, 1)
            fname = f"COCO_gen_{img_id:012d}.jpg"
            Image.fromarray(img).save(
                os.path.join(img_dir, fname), quality=92
            )
            images.append(
                {"id": img_id, "file_name": fname, "height": H, "width": W}
            )
            img_anns = []
            for cid, x1, y1, x2, y2 in placed:
                img_anns.append(
                    {
                        "id": aid,
                        "image_id": img_id,
                        "category_id": cid,
                        "bbox": [float(x1), float(y1),
                                 float(x2 - x1), float(y2 - y1)],
                        "area": float((x2 - x1) * (y2 - y1)),
                        "iscrowd": 0,
                    }
                )
                aid += 1
            annotations.extend(img_anns)
            if is_train:
                for cid in {a["category_id"] for a in img_anns}:
                    by_class[cid].append(
                        (images[-1], [a for a in img_anns
                                      if a["category_id"] == cid])
                    )
        return images, annotations

    tr_imgs, tr_anns = render_split(
        os.path.join(root, "coco", "trainval2014"),
        range(1, train + 1), is_train=True,
    )
    va_imgs, va_anns = render_split(
        os.path.join(root, "coco", "val2014"),
        range(100001, 100001 + val), is_train=False,
    )

    ds = os.path.join(root, "cocosplit", "datasplit")
    os.makedirs(ds, exist_ok=True)
    with open(os.path.join(ds, "trainvalno5k.json"), "w") as f:
        json.dump({"images": tr_imgs, "categories": cats,
                   "annotations": tr_anns}, f)
    with open(os.path.join(ds, "5k.json"), "w") as f:
        json.dump({"images": va_imgs, "categories": cats,
                   "annotations": va_anns}, f)

    short = {i: len(v) for i, v in by_class.items() if len(v) < max(shots)}
    if short:
        raise ValueError(f"classes with too few train images: {short}")

    for seed in seeds:
        sd = os.path.join(root, "cocosplit", f"seed{seed}")
        os.makedirs(sd, exist_ok=True)
        srng = np.random.RandomState(1000 + seed)
        for shot in shots:
            for cat in cats:
                cid, name = cat["id"], cat["name"]
                if cid in by_class:
                    pool = by_class[cid]
                    idx = srng.permutation(len(pool))[:shot]
                    imgs = [pool[j][0] for j in idx]
                    annos = [a for j in idx for a in pool[j][1]]
                else:  # an inactive class: an empty file
                    imgs, annos = [], []
                fn = os.path.join(
                    sd, f"full_box_{shot}shot_{name}_trainval.json"
                )
                with open(fn, "w") as f:
                    json.dump({"images": imgs, "categories": cats,
                               "annotations": annos}, f)
    return len(base), len(novel)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--train", type=int, default=192)
    p.add_argument("--val", type=int, default=60)
    p.add_argument("--shots", type=int, nargs="+", default=[10])
    p.add_argument("--seed", type=int, nargs="+", default=[0])
    p.add_argument("--rng-seed", type=int, default=20260821)
    args = p.parse_args(argv)
    n_base, n_novel = make_generalization_coco(
        args.root, args.train, args.val, args.shots, args.seed,
        args.rng_seed)
    print(
        f"generalization COCO: {args.train} train, {args.val} held-out "
        f"val, {n_base + n_novel} active classes ({n_base} base + "
        f"{n_novel} novel), shots={args.shots} under {args.root}"
    )


if __name__ == "__main__":
    main()
