"""Preflight gate for a real-data VOC few-shot run on this package:

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.preflight_real_voc \\
        [--root datasets] [--shot 10] [--seeds 0 ...] \\
        [--r101 weights/R-101.pkl] [--pcb weights/resnet101-torchvision.pth]

Counterpart of the repository's ``tools/preflight_real_voc.py``, with its
checks, messages and exit codes, one report line an item:
  1. VOC2007 + VOC2012 trees (Annotations / JPEGImages / ImageSets) with
     real image counts, and the vocsplit k-shot files of the requested
     (shot, seeds);
  2. the Caffe2 ImageNet R-101 ``.pkl`` (``MODEL.WEIGHTS`` of the base
     configs): every non-momentum blob but the ImageNet classifier must
     name, through ``checkpoint/torch_import.py`` (``load_c2_pkl``,
     ``c2_to_d2``), a tensor of this package's R-101 detector of the same
     shape. The importer skips any other blob and counts it, so this is
     the check that no weight is dropped without a word;
  3. the torchvision R-101 ``.pth`` that PCB runs: the 522 keys of
     ``evaluation/archs.py`` ``torchvision_r101_manifest``, ``conv1.weight``
     of shape (64, 3, 7, 7).

Exit 0: ready to run; exit 1: the report is printed and nothing started.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

OK = "\033[32mOK\033[0m"
MISSING = "\033[31mMISSING\033[0m"
BAD = "\033[31mBAD\033[0m"

SCRIPTS = "fewshotobjectdetection_imporove_via_text_feature_torch/tools"

VOC_CLASSES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

# the ImageNet classifier: a detector does not read it (detectron2 drops
# it too)
CLASSIFIER_BLOBS = ("fc1000_w", "fc1000_b", "pred_w", "pred_b")


def check_voc_tree(root, year, min_images):
    d = os.path.join(root, f"VOC{year}")
    problems = []
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        if not os.path.isdir(os.path.join(d, sub)):
            problems.append(f"{d}/{sub} missing")
    if not problems:
        n = len(os.listdir(os.path.join(d, "JPEGImages")))
        if n < min_images:
            problems.append(
                f"{d}/JPEGImages has {n} images; real VOC{year} has "
                f">{min_images} — this looks like synthetic smoke data"
            )
        for split in ("trainval",) + (("test",) if year == 2007 else ()):
            f = os.path.join(d, "ImageSets", "Main", f"{split}.txt")
            if not os.path.isfile(f):
                problems.append(f"{f} missing")
    return problems


def check_vocsplit(root, shot, seeds):
    problems = []
    for seed in seeds:
        # the loader reads seed files under seed{N}/ only, seed 0 too
        # (data/meta_voc.py), so a flat layout must not pass the gate
        sd = os.path.join(root, "vocsplit", f"seed{seed}")
        missing = [
            c for c in VOC_CLASSES
            if not os.path.isfile(
                os.path.join(sd, f"box_{shot}shot_{c}_train.txt")
            )
        ]
        if missing:
            problems.append(
                f"{sd}: box_{shot}shot_*_train.txt missing for "
                f"{len(missing)} classes (e.g. {missing[:3]})"
            )
    return problems


@functools.lru_cache(maxsize=1)
def r101_tensor_shapes():
    """name -> shape of every tensor of this package's R-101 detector (the
    base configs' model), built on the meta device: no memory, no numbers."""
    import torch

    from ..config import get_cfg
    from ..models import build_model

    cfg = get_cfg()
    cfg.MODEL.RESNETS.DEPTH = 101
    with torch.device("meta"):
        model = build_model(cfg)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def check_r101_pkl(path):
    """Every blob must load into a tensor of the R-101 detector."""
    if not os.path.isfile(path):
        return [f"{path} missing (detectron2 zoo: ImageNetPretrained/MSRA/R-101.pkl)"]
    from ..checkpoint.torch_import import c2_to_d2, load_c2_pkl

    try:
        blobs = load_c2_pkl(path)
    except Exception as e:
        return [f"{path}: unreadable ({e})"]
    problems = []
    if "conv1_w" not in blobs:
        problems.append(f"{path}: no conv1_w blob — not a Caffe2 backbone file")
        return problems
    if tuple(blobs["conv1_w"].shape) != (64, 3, 7, 7):
        problems.append(
            f"{path}: conv1_w shape {blobs['conv1_w'].shape} != (64,3,7,7)"
        )
    shapes = r101_tensor_shapes()
    unmapped = []
    for name, blob in blobs.items():
        if name in CLASSIFIER_BLOBS:
            continue
        target = c2_to_d2(name)
        if shapes.get(target) != tuple(blob.shape):
            unmapped.append(name)
    if unmapped:
        problems.append(
            f"{path}: {len(unmapped)} blobs do not translate "
            f"(e.g. {unmapped[:4]}) — import would silently drop weights"
        )
    # depth: R-101 has res4 blocks 0..22
    if "res4_22_branch2c_w" not in blobs:
        problems.append(f"{path}: res4_22 missing — not a ResNet-101 file")
    return problems


def check_pcb_pth(path):
    if not os.path.isfile(path):
        return [
            f"{path} missing (torchvision resnet101; the reference uses "
            "resnet101-5d3b4d8f.pth)"
        ]
    from ..checkpoint.torch_import import load_torch_state
    from ..evaluation.archs import torchvision_r101_manifest

    try:
        state = load_torch_state(path)
    except Exception as e:
        return [f"{path}: unreadable ({e})"]
    problems = []
    manifest = torchvision_r101_manifest()
    missing = [k for k in manifest if k not in state]
    if missing:
        problems.append(
            f"{path}: {len(missing)}/{len(manifest)} manifest keys missing "
            f"(e.g. {missing[:3]})"
        )
    if "conv1.weight" in state and tuple(state["conv1.weight"].shape) != (
        64, 3, 7, 7,
    ):
        problems.append(f"{path}: conv1.weight shape wrong")
    return problems


def report(checks, script):
    """Print one line an item and its problems; the exit code."""
    failed = False
    for name, problems in checks:
        print(f"[{MISSING if problems else OK}] {name}")
        for p in problems:
            print(f"      - {p}")
        failed |= bool(problems)
    if failed:
        print(
            "\nPreflight FAILED — supply the items above, then rerun "
            f"{SCRIPTS}/{script}. Nothing was started."
        )
        return 1
    print("\nPreflight OK — data and weights verified.")
    return 0


def weight_args(ap):
    ap.add_argument("--root", default="datasets")
    ap.add_argument("--shot", type=int, default=10)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--r101", default="weights/R-101.pkl")
    ap.add_argument("--pcb", default="weights/resnet101-torchvision.pth")
    return ap


def main(argv=None):
    args = weight_args(argparse.ArgumentParser()).parse_args(argv)
    return report([
        ("VOC2007 tree", check_voc_tree(args.root, 2007, 5000)),
        ("VOC2012 tree", check_voc_tree(args.root, 2012, 10000)),
        (
            f"vocsplit {args.shot}-shot seeds {args.seeds}",
            check_vocsplit(args.root, args.shot, args.seeds),
        ),
        ("R-101.pkl import coverage", check_r101_pkl(args.r101)),
        ("PCB torchvision weights", check_pcb_pth(args.pcb)),
    ], "run_real_voc.sh")


if __name__ == "__main__":
    sys.exit(main())
