"""Preflight gate for a real-data COCO few-shot run on this package:

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.preflight_real_coco \\
        [--root datasets] [--shot 10] [--seeds 0 ...] \\
        [--r101 weights/R-101.pkl] [--pcb weights/resnet101-torchvision.pth]

Counterpart of the repository's ``tools/preflight_real_coco.py``, with its
checks, messages and exit codes (0: ready; 1: the report is printed and
nothing started):
  1. coco/trainval2014 and coco/val2014 image trees with real image counts
     (real trainval2014 has about 123k images; a handful is smoke data);
  2. cocosplit/datasplit/{trainvalno5k,5k}.json, the base-training and
     test annotations the registry reads (``data/builtin.py``), by size:
     the real trainvalno5k.json is about 450 MB, and parsing it belongs to
     the run, not to the gate;
  3. cocosplit/seed{S}/full_box_{K}shot_{cls}_trainval.json for each of
     the 80 classes (raw class names, spaces included);
  4. the R-101 ``.pkl`` and PCB's torchvision ``.pth``, by the VOC
     preflight's checks.
"""

from __future__ import annotations

import argparse
import os
import sys

from .preflight_real_voc import check_pcb_pth, check_r101_pkl, report, weight_args


def coco_class_names():
    from ..data.builtin_meta import COCO_THING_CATEGORIES

    return [n for _, n in COCO_THING_CATEGORIES]


def check_image_tree(root, subdir, min_images):
    d = os.path.join(root, "coco", subdir)
    if not os.path.isdir(d):
        return [f"{d} missing"]
    n = len(os.listdir(d))
    if n < min_images:
        return [
            f"{d} has {n} images; real COCO {subdir} has >{min_images} — "
            "this looks like synthetic smoke data"
        ]
    return []


def check_datasplit(root):
    problems = []
    for name, min_mb in (("trainvalno5k.json", 50), ("5k.json", 2)):
        f = os.path.join(root, "cocosplit", "datasplit", name)
        if not os.path.isfile(f):
            problems.append(f"{f} missing")
            continue
        mb = os.path.getsize(f) / 1e6
        if mb < min_mb:
            problems.append(
                f"{f} is {mb:.1f} MB; the real file is >{min_mb} MB — "
                "truncated or synthetic"
            )
    return problems


def check_cocosplit(root, shot, seeds):
    problems = []
    classes = coco_class_names()
    for seed in seeds:
        sd = os.path.join(root, "cocosplit", f"seed{seed}")
        missing = [
            c for c in classes
            if not os.path.isfile(
                os.path.join(sd, f"full_box_{shot}shot_{c}_trainval.json")
            )
        ]
        if missing:
            problems.append(
                f"{sd}: full_box_{shot}shot_*_trainval.json missing for "
                f"{len(missing)}/80 classes (e.g. {missing[:3]})"
            )
    return problems


def main(argv=None):
    args = weight_args(argparse.ArgumentParser()).parse_args(argv)
    return report([
        ("coco/trainval2014 tree",
         check_image_tree(args.root, "trainval2014", 100000)),
        ("coco/val2014 tree", check_image_tree(args.root, "val2014", 30000)),
        ("cocosplit/datasplit jsons", check_datasplit(args.root)),
        (
            f"cocosplit {args.shot}-shot seeds {args.seeds}",
            check_cocosplit(args.root, args.shot, args.seeds),
        ),
        ("R-101.pkl import coverage", check_r101_pkl(args.r101)),
        ("PCB torchvision weights", check_pcb_pth(args.pcb)),
    ], "run_real_coco.sh")


if __name__ == "__main__":
    sys.exit(main())
