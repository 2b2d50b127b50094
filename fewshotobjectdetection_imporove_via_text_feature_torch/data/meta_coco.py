"""COCO dataset loading from plain json (no pycocotools), counterpart of the
JAX package's ``data/meta_coco.py`` (ref defrcn/data/meta_coco.py:14-97):
a standard split reads one annotation json; a "shot" split merges the
per-class ``cocosplit/seed{S}/full_box_{K}shot_{cls}_trainval.json`` files
by image id. Category ids are remapped to contiguous [0, C) through the
split's id map; XYWH boxes become XYXY, and each annotation keeps its
``area`` field, which the COCO evaluator's area ranges read.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

from .catalog import DatasetCatalog, MetadataCatalog

__all__ = ["register_meta_coco", "load_coco_json"]


def _index_coco(json_path):
    with open(json_path) as f:
        data = json.load(f)
    imgs = {img["id"]: img for img in data["images"]}
    anns = defaultdict(list)
    for ann in data.get("annotations", []):
        anns[ann["image_id"]].append(ann)
    return imgs, anns


def load_coco_json(json_file, image_root, metadata, dataset_name,
                   root="datasets"):
    if "shot" in dataset_name:
        imgid2img = {}
        imgid2anns = defaultdict(list)
        shot = dataset_name.split("_")[-2].split("shot")[0]
        seed = int(dataset_name.split("_seed")[-1])
        split_dir = os.path.join(root, "cocosplit", f"seed{seed}")
        for cls in metadata["thing_classes"]:
            imgs, anns = _index_coco(os.path.join(
                split_dir, f"full_box_{shot}shot_{cls}_trainval.json"))
            for img_id in sorted(imgs):
                if img_id not in imgid2img:
                    imgid2img[img_id] = imgs[img_id]
                imgid2anns[img_id].extend(anns[img_id])
        img_ids = list(imgid2img)
        imgs = [imgid2img[i] for i in img_ids]
        anns_list = [imgid2anns[i] for i in img_ids]
    else:
        imgs_idx, anns_idx = _index_coco(json_file)
        img_ids = sorted(imgs_idx)
        imgs = [imgs_idx[i] for i in img_ids]
        anns_list = [anns_idx[i] for i in img_ids]

    id_map = metadata["thing_dataset_id_to_contiguous_id"]
    dataset_dicts = []
    for img, anns in zip(imgs, anns_list):
        record = {
            "file_name": os.path.join(image_root, img["file_name"]),
            "height": img["height"],
            "width": img["width"],
            "image_id": img["id"],
        }
        objs = []
        for ann in anns:
            if ann["image_id"] != img["id"]:
                raise ValueError(f"{dataset_name}: annotation {ann.get('id')}"
                                 f" of image {ann['image_id']} listed under "
                                 f"image {img['id']}")
            if ann.get("ignore", 0) != 0:
                continue
            cid = ann["category_id"]
            if cid not in id_map:
                continue
            x, y, w, h = ann["bbox"]
            objs.append({
                "category_id": id_map[cid],
                "bbox": [x, y, x + w, y + h],
                "iscrowd": ann.get("iscrowd", 0),
                # COCOeval's area ranges read the annotation's area (the
                # segmentation's on real COCO), not the box's
                "area": ann.get("area", w * h),
            })
        record["annotations"] = objs
        dataset_dicts.append(record)
    return dataset_dicts


def register_meta_coco(name, metadata, imgdir, annofile, root="datasets"):
    metadata = dict(metadata)
    if "_base" in name or "_novel" in name:
        split = "base" if "_base" in name else "novel"
        metadata["thing_dataset_id_to_contiguous_id"] = metadata[
            f"{split}_dataset_id_to_contiguous_id"]
        metadata["thing_classes"] = metadata[f"{split}_classes"]

    DatasetCatalog.register(
        name, lambda: load_coco_json(annofile, imgdir, metadata, name, root))
    MetadataCatalog.get(name).set(
        json_file=annofile,
        image_root=imgdir,
        evaluator_type="coco",
        dirname=os.path.join(root, "coco"),
        **metadata,
    )
