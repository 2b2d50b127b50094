"""The mAP overfit check on the port: train a detector on 6 synthetic images
of visible objects (solid coloured rectangles on grey, class = colour), then
evaluate it on those same images through inference and the VOC evaluator.
Loss curves cannot see a coordinate or evaluator misalignment; a high AP50
here shows that train -> detect -> rescale -> match -> AP agree end to end.

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.overfit_map_check \\
        [--production] [--head SematicRes5ROIHeads|TextRes5ROIHeads] \\
        [--pcb] [--device cpu]

Counterpart of the repository's ``tools/overfit_map_check.py``: the same
data, configs and asserts, on this package's ``Trainer``,
``cli.do_test`` and VOC evaluator. The default is the tiny detector
(depth 14, 256x384, float32, 500 iterations); ``--production`` is the
flagship at full width: R-101 C4 at 800x1344, FREEZE_AT 0, batch 6, 300
iterations, bf16. ``--head`` trains a text or semantic head (teacher and
student, no distillation) and evaluates its student. ``--pcb`` evaluates
the trained model again with PCB on seeded ResNet weights
(TEST.PCB_MODELPATH ""): the detection set must stay the same, every
score in PCB's window must change and no other. It runs on the card
unless ``--device cpu``.

Prints one JSON line (AP50, recall, PCB's counts, wall seconds, the median
step ms from the Trainer's own timing: metrics.json's
``time_since_last_log`` over each 20-step window, which ends in the log's
read of the losses), then raises AssertionError when recall@0.5 < 0.9 or
AP50 <= 12 (3 of 20 classes exist, so a perfect detector scores 15.0).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time

import numpy as np

VOC_XML = """<annotation>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
  {objs}
</annotation>"""
OBJ_XML = """<object>
    <name>{name}</name><difficult>0</difficult>
    <bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>
  </object>"""

CLASS_COLORS = {"dog": (220, 40, 40), "cat": (40, 220, 40), "bird": (40, 40, 220)}

TRAIN, TEST = "voc_mapof_all1_t_train", "voc_mapof_all1_t_test"
RECALL_MIN = 0.9
AP50_MIN = 12.0
# PCB leaves a score outside its window as it was, within this
PCB_SCORE_TOL = 1e-6
HEADS = ("SematicRes5ROIHeads", "TextRes5ROIHeads")


def make_visual_voc(root, n=6):
    """VOC2007 under ``root``: ``n`` 320x240 images, each with one dog,
    cat and bird rectangle of its class's colour; ``trainval`` lists
    them. Returns the VOC2007 directory."""
    from PIL import Image

    d = os.path.join(root, "VOC2007")
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    rng = np.random.RandomState(7)
    ids = []
    for i in range(n):
        fid = f"{i:06d}"
        ids.append(fid)
        w, h = 320, 240
        img = np.full((h, w, 3), 128, np.uint8)
        objs = ""
        for name in ("dog", "cat", "bird"):
            bw, bh = int(rng.randint(50, 90)), int(rng.randint(50, 90))
            x1 = int(rng.randint(0, w - bw))
            y1 = int(rng.randint(0, h - bh))
            img[y1:y1 + bh, x1:x1 + bw] = CLASS_COLORS[name]
            objs += OBJ_XML.format(
                name=name, x1=x1 + 1, y1=y1 + 1, x2=x1 + bw, y2=y1 + bh
            )
        with open(os.path.join(d, "Annotations", fid + ".xml"), "w") as f:
            f.write(VOC_XML.format(w=w, h=h, objs=objs))
        Image.fromarray(img).save(os.path.join(d, "JPEGImages", fid + ".jpg"))
    with open(os.path.join(d, "ImageSets/Main", "trainval.txt"), "w") as f:
        f.write("\n".join(ids))
    return d


def memorized_set_recall(dets, anno_dir, name_to_id, iou_thresh=0.5):
    """recall@iou over EVERY annotation file in anno_dir: the dataset is
    iterated, not the detections, so an image with no detection counts
    its objects as misses. ``dets``: COCO-style records (image_id,
    category_id, bbox x, y, w, h). Returns (hit, total)."""
    import xml.etree.ElementTree as ET

    total = hit = 0
    for fn in sorted(os.listdir(anno_dir)):
        if not fn.endswith(".xml"):
            continue
        fid = fn[:-4]
        tree = ET.parse(os.path.join(anno_dir, fn))
        for obj in tree.findall("object"):
            total += 1
            bb = obj.find("bndbox")
            # the loader applies the VOC -1 origin shift
            g = [float(bb.find(t).text) - (1 if t in ("xmin", "ymin") else 0)
                 for t in ("xmin", "ymin", "xmax", "ymax")]
            cid = name_to_id[obj.find("name").text]
            for dd in dets:
                if dd["image_id"] != fid or dd["category_id"] != cid:
                    continue
                x, y, w, h = dd["bbox"]
                ix = max(0, min(g[2], x + w) - max(g[0], x))
                iy = max(0, min(g[3], y + h) - max(g[1], y))
                inter = ix * iy
                union = (g[2] - g[0]) * (g[3] - g[1]) + w * h - inter
                if inter / union > iou_thresh:
                    hit += 1
                    break
    return hit, total


def register_visual_voc(root, names):
    """``make_visual_voc`` under ``root``, registered as each of ``names``
    (split 1's 20 classes; a name registered before is replaced). Returns
    the VOC2007 directory."""
    from ..data import DatasetCatalog
    from ..data.builtin_meta import _get_builtin_metadata
    from ..data.meta_voc import register_meta_voc

    d = make_visual_voc(root)
    meta = _get_builtin_metadata("voc_fewshot")
    for split in names:
        if split in DatasetCatalog:
            DatasetCatalog.remove(split)
        register_meta_voc(
            split, meta, d, "trainval", 2007, "base_novel_1", 1, root=root
        )
    return d


def tiny_cfg(cfg):
    """The tiny detector of the CPU checks (depth 14 at 256x384, float32)."""
    cfg.MODEL.RESNETS.DEPTH = 14
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 8
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 16
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 4
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 32
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 256
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 64
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 256
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 64
    cfg.TPU.IMAGE_BUCKETS = ((256, 384),)
    cfg.TPU.MAX_GT = 10
    cfg.TPU.MAX_DETECTIONS_PRE_NMS = 128
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.INPUT.MIN_SIZE_TRAIN = (256,)
    cfg.INPUT.MAX_SIZE_TRAIN = 384
    cfg.INPUT.MIN_SIZE_TEST = 256
    cfg.INPUT.MAX_SIZE_TEST = 384


def production_shapes(cfg):
    """The flagship's full-width shapes: R-101 at 800x1344, every stage
    trained, the default bf16."""
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.TPU.IMAGE_BUCKETS = ((800, 1344),)
    cfg.INPUT.MIN_SIZE_TRAIN = (800,)
    cfg.INPUT.MAX_SIZE_TRAIN = 1333
    cfg.INPUT.MIN_SIZE_TEST = 800
    cfg.INPUT.MAX_SIZE_TEST = 1333


def overfit_cfg(root, production=False, head=None):
    """The check's config, as the repository's tool sets it; outputs under
    ``root``/out."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 20
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.3
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.SOLVER.IMS_PER_BATCH = 6
    cfg.SOLVER.WARMUP_ITERS = 50
    if production:
        production_shapes(cfg)
        cfg.SOLVER.MAX_ITER = 300
        cfg.SOLVER.STEPS = (220, 270)
        cfg.SOLVER.BASE_LR = 0.01
    else:
        tiny_cfg(cfg)
        cfg.SOLVER.MAX_ITER = 500
        cfg.SOLVER.STEPS = (380, 450)
        cfg.SOLVER.BASE_LR = 0.02
    if head:
        # the reference's active student recipe (run_text_train_Student.sh:
        # 55-59): teacher and student CE-trained, no distillation; the
        # class bank is the synthetic one (no GloVe files); the student's
        # confidence ramps slower, so the reference's test threshold
        cfg.MODEL.ROI_HEADS.NAME = head
        cfg.MODEL.ADDITION.NAME = "glove"
        cfg.MODEL.ROI_HEADS.TEACHER_TRAINING = True
        cfg.MODEL.ROI_HEADS.STUDENT_TRAINING = True
        cfg.MODEL.ROI_HEADS.DISTILLATE = False
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    cfg.SOLVER.CHECKPOINT_PERIOD = 0
    cfg.TEST.EVAL_PERIOD = 0
    cfg.DATASETS.TRAIN = (TRAIN,)
    cfg.DATASETS.TEST = (TEST,)
    cfg.OUTPUT_DIR = os.path.join(root, "out")
    cfg.SEED = 11
    return cfg


def apply_args(cfg, args):
    """``--device`` (MODEL.DEVICE), then ``--opts``."""
    if args.device:
        cfg.MODEL.DEVICE = args.device
    cfg.merge_from_list(args.opts)
    return cfg


def logged_step_ms(output_dir):
    """Median ms a step over the Trainer's logged windows: each
    metrics.json row's ``time_since_last_log`` over the iterations since
    the row before (the first row, one step with the start-up, left
    out)."""
    from ..utils.events import read_metrics

    rows = read_metrics(output_dir)
    per = [1e3 * b["time_since_last_log"] / (b["iteration"] - a["iteration"])
           for a, b in zip(rows, rows[1:])]
    return statistics.median(per) if per else float("nan")


def detections(output_dir):
    with open(os.path.join(output_dir, "coco_instances_results.json")) as f:
        return json.load(f)


def recall_of(dets, voc_dir, dataset):
    """(hit, total) of ``memorized_set_recall`` over ``voc_dir``'s
    annotations, class ids from ``dataset``'s metadata."""
    from ..data import MetadataCatalog

    classes = MetadataCatalog.get(dataset).thing_classes
    name_to_id = {n: i for i, n in enumerate(classes)}
    return memorized_set_recall(
        dets, os.path.join(voc_dir, "Annotations"), name_to_id)


def pcb_window_check(base_dets, pcb_dets, lower, upper):
    """PCB only rescores: the detection set (image, class, box to 0.01)
    is the same, every score in (lower, upper] changes and no other does
    (within PCB_SCORE_TOL). Returns (in-window, changed); raises
    AssertionError otherwise."""
    def key(dd):
        return (dd["image_id"], dd["category_id"],
                tuple(round(v, 2) for v in dd["bbox"]))

    base = {key(dd): dd["score"] for dd in base_dets}
    rescored = {key(dd): dd["score"] for dd in pcb_dets}
    if set(rescored) != set(base):
        raise AssertionError(
            "PCB must only rescore, not change the detection set: "
            f"{len(base)} vs {len(rescored)}")
    changed = in_window = 0
    for k, s0 in base.items():
        s1 = rescored[k]
        if lower < s0 <= upper:
            in_window += 1
            changed += abs(s1 - s0) > PCB_SCORE_TOL
        elif abs(s1 - s0) > PCB_SCORE_TOL:
            raise AssertionError(f"PCB moved a score outside its window: "
                                 f"{k} {s0} -> {s1}")
    if in_window == 0:
        raise AssertionError("no detection in PCB's window")
    if changed == 0:
        raise AssertionError("PCB rescoring altered no in-window score")
    return in_window, changed


def main(argv=None, root=None):
    """Runs the check and returns its numbers with the trained
    ``trainer`` (for callers that look further). Data and outputs go
    under ``root`` (a new temporary directory by default)."""
    import torch

    from .. import cli
    from ..engine import Trainer

    p = argparse.ArgumentParser()
    p.add_argument("--production", action="store_true")
    p.add_argument("--head", choices=HEADS, default=None)
    p.add_argument("--pcb", action="store_true")
    p.add_argument("--device", default=None,
                   help="MODEL.DEVICE (default: the config's, cuda)")
    p.add_argument("--opts", default=[], nargs=argparse.REMAINDER,
                   help="KEY VALUE pairs merged last (e.g. "
                        "TPU.COMPUTE_DTYPE float32 to look for a bf16 fault)")
    args = p.parse_args(argv)

    root = root or tempfile.mkdtemp()
    d = register_visual_voc(root, (TRAIN, TEST))
    cfg = apply_args(overfit_cfg(root, args.production, args.head), args)
    on_cuda = cfg.MODEL.DEVICE.startswith("cuda")
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()

    t0 = time.time()
    tr = Trainer(cfg)
    tr.train()
    train_s = time.time() - t0
    res = cli.do_test(cfg, model=tr.model)
    ap50 = res[TEST]["bbox"]["AP50"]
    dets = detections(cfg.OUTPUT_DIR)
    hit, total = recall_of(dets, d, TEST)
    out = dict(check="overfit_map", production=args.production,
               head=args.head or cfg.MODEL.ROI_HEADS.NAME,
               device=cfg.MODEL.DEVICE, ap50=ap50, recall=hit / max(total, 1),
               hit=hit, total=total, train_s=train_s,
               step_ms_median=logged_step_ms(cfg.OUTPUT_DIR))

    failures = []
    if out["recall"] < RECALL_MIN:
        failures.append(f"overfit recall too low: {out['recall']}")
    if not ap50 > AP50_MIN:
        failures.append(f"overfit AP50 too low: {ap50}")
    if args.pcb and not failures:
        # PCB on the trained model: prototypes from the train images
        # (1x1 ROIAlign at 1/32 over a seeded ResNet: no ImageNet file
        # here, but on colour-coded data its features still separate the
        # classes), every detection in (PCB_LOWER, PCB_UPPER] rescored
        cfg.TEST.PCB_ENABLE = True
        cfg.TEST.PCB_MODELPATH = ""
        cfg.OUTPUT_DIR = os.path.join(root, "out_pcb")
        os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
        cli.do_test(cfg, model=tr.model)
        dets_pcb = detections(cfg.OUTPUT_DIR)
        try:
            out["pcb_in_window"], out["pcb_rescored"] = pcb_window_check(
                dets, dets_pcb, cfg.TEST.PCB_LOWER, cfg.TEST.PCB_UPPER)
        except AssertionError as e:
            failures.append(str(e))
        hit2, total2 = recall_of(dets_pcb, d, TEST)
        out["pcb_recall"] = hit2 / max(total2, 1)
        if out["pcb_recall"] < RECALL_MIN:
            failures.append(f"recall with PCB too low: {out['pcb_recall']}")
    out["wall_s"] = time.time() - t0
    if on_cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps(out), flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    print("MAP OVERFIT CHECK PASSED" + (" (PCB too)" if args.pcb else ""))
    return {**out, "trainer": tr}


if __name__ == "__main__":
    main()
