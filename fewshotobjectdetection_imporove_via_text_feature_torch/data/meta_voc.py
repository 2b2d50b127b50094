"""Pascal VOC dataset loading, with the few-shot k-shot splits.

Counterpart of the JAX package's ``data/meta_voc.py`` (ref
defrcn/data/meta_voc.py:12-156):
  * full splits: parse every XML in ImageSets/Main/<split>.txt, keep only
    annotations whose class is in the split's class list, XYXY boxes with
    the VOC -1 pixel origin shift;
  * "shot" splits: read datasets/vocsplit/seed{S}/box_{K}shot_{cls}_train.txt
    per class, one single-instance record per matching object per file
    entry, then subsample to K records per class when more exist, with a
    ``RandomState`` seeded from the CRC32 of the dataset name (the same
    draw as the JAX package, in every process and run).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
import zlib

import numpy as np

from .catalog import DatasetCatalog, MetadataCatalog

__all__ = ["register_meta_voc", "load_filtered_voc_instances"]


def _parse_voc_xml(anno_file: str):
    tree = ET.parse(anno_file)
    size = tree.find("size")
    height = int(size.find("height").text)
    width = int(size.find("width").text)
    objs = []
    for obj in tree.findall("object"):
        cls = obj.find("name").text
        bb = obj.find("bndbox")
        bbox = [
            float(bb.find(x).text) for x in ("xmin", "ymin", "xmax", "ymax")
        ]
        # VOC pixel indexing starts at 1.
        bbox[0] -= 1.0
        bbox[1] -= 1.0
        difficult = obj.find("difficult")
        objs.append(
            {
                "name": cls,
                "bbox": bbox,
                "difficult": int(difficult.text) if difficult is not None else 0,
            }
        )
    return height, width, objs


def load_filtered_voc_instances(
    name: str, dirname: str, split: str, classnames, root: str = "datasets"
):
    is_shots = "shot" in name
    dicts = []
    if is_shots:
        shot = name.split("_")[-2].split("shot")[0]
        seed = int(name.split("_seed")[-1])
        split_dir = os.path.join(root, "vocsplit", f"seed{seed}")
        rng = np.random.RandomState(zlib.crc32(name.encode()) % (2**31))
        for cls in classnames:
            fn = os.path.join(split_dir, f"box_{shot}shot_{cls}_train.txt")
            with open(fn) as f:
                fileids = [
                    line.strip().split("/")[-1].split(".jpg")[0]
                    for line in f
                    if line.strip()
                ]
            dicts_ = []
            for fileid in fileids:
                year = "2012" if "_" in fileid else "2007"
                d = os.path.join(root, f"VOC{year}")
                anno_file = os.path.join(d, "Annotations", fileid + ".xml")
                jpeg_file = os.path.join(d, "JPEGImages", fileid + ".jpg")
                height, width, objs = _parse_voc_xml(anno_file)
                for obj in objs:
                    if obj["name"] != cls:
                        continue
                    dicts_.append(
                        {
                            "file_name": jpeg_file,
                            "image_id": fileid,
                            "height": height,
                            "width": width,
                            "annotations": [
                                {
                                    "category_id": classnames.index(cls),
                                    "bbox": obj["bbox"],
                                }
                            ],
                        }
                    )
            if len(dicts_) > int(shot):
                idx = rng.choice(len(dicts_), int(shot), replace=False)
                dicts_ = [dicts_[i] for i in idx]
            dicts.extend(dicts_)
    else:
        with open(
            os.path.join(dirname, "ImageSets", "Main", split + ".txt")
        ) as f:
            fileids = [line.strip() for line in f if line.strip()]
        for fileid in fileids:
            anno_file = os.path.join(dirname, "Annotations", fileid + ".xml")
            jpeg_file = os.path.join(dirname, "JPEGImages", fileid + ".jpg")
            height, width, objs = _parse_voc_xml(anno_file)
            annos = [
                {
                    "category_id": classnames.index(o["name"]),
                    "bbox": o["bbox"],
                    "difficult": o["difficult"],
                }
                for o in objs
                if o["name"] in classnames
            ]
            dicts.append(
                {
                    "file_name": jpeg_file,
                    "image_id": fileid,
                    "height": height,
                    "width": width,
                    "annotations": annos,
                }
            )
    return dicts


def register_meta_voc(name, metadata, dirname, split, year, keepclasses, sid,
                      root="datasets"):
    if keepclasses.startswith("base_novel"):
        thing_classes = metadata["thing_classes"][sid]
    elif keepclasses.startswith("base"):
        thing_classes = metadata["base_classes"][sid]
    elif keepclasses.startswith("novel"):
        thing_classes = metadata["novel_classes"][sid]
    else:
        raise ValueError(keepclasses)

    DatasetCatalog.register(
        name,
        lambda: load_filtered_voc_instances(
            name, dirname, split, thing_classes, root=root
        ),
    )
    MetadataCatalog.get(name).set(
        thing_classes=thing_classes,
        dirname=dirname,
        year=year,
        split=split,
        base_classes=metadata["base_classes"][sid],
        novel_classes=metadata["novel_classes"][sid],
        evaluator_type="pascal_voc",
    )
