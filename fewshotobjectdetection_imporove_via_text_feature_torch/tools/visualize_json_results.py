"""Draw predictions beside the ground truth, one image a file:

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.visualize_json_results \\
        --input OUT/coco_instances_results.json --output OUT/visualizations \\
        [--dataset voc_2007_test_all1] [--conf-threshold 0.5]

Counterpart of the repository's ``visualize_json_results.py`` (ref
visualize_json_results.py:42-101), over this package's dataset registry
(datasets under ``$FSODTF_DATASETS``, default ``datasets``, as the CLI
reads them): the same boxes, labels, colours and ``{image_id}.jpg`` files,
drawn with PIL on the originals. The predictions are the
``coco_instances_results.json`` the evaluators write: records of
``image_id``, ``bbox`` (x, y, w, h), ``score`` and ``category_id``, a
dataset id where the dataset maps ids (COCO), else a contiguous index
(VOC). PIL is imported only when an image is drawn.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np


def _color(i):
    rng = np.random.RandomState(i * 7919 + 13)
    return tuple(int(v) for v in rng.randint(64, 255, 3))


def draw(img, boxes, labels, colors, width=2):
    from PIL import ImageDraw

    d = ImageDraw.Draw(img)
    for box, label, color in zip(boxes, labels, colors):
        x1, y1, x2, y2 = [float(v) for v in box]
        d.rectangle([x1, y1, x2, y2], outline=color, width=width)
        d.text((x1 + 2, max(y1 - 12, 0)), label, fill=color)
    return img


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, help="predictions json")
    p.add_argument("--output", required=True, help="output dir")
    p.add_argument("--dataset", default="voc_2007_test_all1")
    p.add_argument("--conf-threshold", type=float, default=0.5)
    args = p.parse_args(argv)

    from PIL import Image

    from ..data import MetadataCatalog, get_detection_dataset_dicts, register_all

    register_all(os.environ.get("FSODTF_DATASETS", "datasets"))
    meta = MetadataCatalog.get(args.dataset)
    classes = meta.thing_classes
    id_map = meta.get("thing_dataset_id_to_contiguous_id")
    to_contig = (lambda c: id_map.get(c, 0)) if id_map else (lambda c: c)
    dicts = get_detection_dataset_dicts([args.dataset], filter_empty=False)
    by_id = {r["image_id"]: r for r in dicts}

    with open(args.input) as f:
        preds = json.load(f)
    grouped = defaultdict(list)
    for pr in preds:
        grouped[pr["image_id"]].append(pr)

    os.makedirs(args.output, exist_ok=True)
    for image_id, prs in grouped.items():
        rec = by_id.get(image_id)
        if rec is None:
            continue
        img = Image.open(rec["file_name"]).convert("RGB")
        w, h = img.size

        pred_img = img.copy()
        keep = [p for p in prs if p["score"] >= args.conf_threshold]
        draw(
            pred_img,
            [
                [p["bbox"][0], p["bbox"][1],
                 p["bbox"][0] + p["bbox"][2], p["bbox"][1] + p["bbox"][3]]
                for p in keep
            ],
            [
                f"{classes[to_contig(p['category_id'])]} {p['score']:.2f}"
                for p in keep
            ],
            [_color(to_contig(p["category_id"])) for p in keep],
        )

        gt_img = img.copy()
        annos = rec.get("annotations", [])
        draw(
            gt_img,
            [a["bbox"] for a in annos],
            [classes[a["category_id"]] for a in annos],
            [_color(a["category_id"]) for a in annos],
        )

        combo = Image.new("RGB", (w * 2 + 4, h), (255, 255, 255))
        combo.paste(pred_img, (0, 0))
        combo.paste(gt_img, (w + 4, 0))
        combo.save(os.path.join(args.output, f"{image_id}.jpg"))
    print(f"wrote {len(grouped)} visualizations to {args.output}")
    return len(grouped)


if __name__ == "__main__":
    main()
