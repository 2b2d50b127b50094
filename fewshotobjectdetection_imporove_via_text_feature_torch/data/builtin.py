"""Built-in dataset registration, counterpart of the JAX package's
``data/builtin.py``, with the reference's dataset names
(defrcn/data/builtin.py:10-95) so configs and run scripts carry over.

VOC = {year} x {trainval base/all, 2007-test base/novel/all} x split id,
plus the 30-seeded k-shot few-shot names; COCO = trainval/test x
all/base/novel over the cocosplit json layout, plus the 10-seeded k-shot
names.
"""

from __future__ import annotations

import os

from .builtin_meta import _get_builtin_metadata
from .catalog import DatasetCatalog
from .meta_coco import register_meta_coco
from .meta_voc import register_meta_voc

_registered_root = None
_registered_names = []


def _voc_static_splits():
    out = []
    for year in (2007, 2012):
        for sid in (1, 2, 3):
            out.append(
                (f"voc_{year}_trainval_base{sid}", f"VOC{year}",
                 "trainval", f"base{sid}", sid)
            )
    for year in (2007, 2012):
        for sid in (1, 2, 3):
            out.append(
                (f"voc_{year}_trainval_all{sid}", f"VOC{year}",
                 "trainval", f"base_novel_{sid}", sid)
            )
    for kind in ("base", "novel", "all"):
        keep = {"base": "base{0}", "novel": "novel{0}",
                "all": "base_novel_{0}"}[kind]
        for sid in (1, 2, 3):
            out.append(
                (f"voc_2007_test_{kind}{sid}", "VOC2007", "test",
                 keep.format(sid), sid)
            )
    return out


def _voc_fewshot_splits():
    out = []
    for prefix in ("all", "novel"):
        for sid in (1, 2, 3):
            for shot in (1, 2, 3, 5, 10):
                for year in (2007, 2012):
                    for seed in range(30):
                        name = (
                            f"voc_{year}_trainval_{prefix}{sid}_{shot}shot"
                            f"_seed{seed}"
                        )
                        keep = (
                            f"base_novel_{sid}" if prefix == "all"
                            else f"novel{sid}"
                        )
                        out.append(
                            (name, f"VOC{year}",
                             f"{prefix}_{shot}shot_split_{sid}_trainval",
                             keep, sid)
                        )
    return out


_COCO_TRAINVAL_JSON = "cocosplit/datasplit/trainvalno5k.json"
_COCO_5K_JSON = "cocosplit/datasplit/5k.json"


def register_all_coco(root="datasets"):
    splits = [
        ("coco14_trainval_all", "coco/trainval2014", _COCO_TRAINVAL_JSON),
        ("coco14_trainval_base", "coco/trainval2014", _COCO_TRAINVAL_JSON),
    ]
    splits += [(f"coco14_test_{kind}", "coco/val2014", _COCO_5K_JSON)
               for kind in ("all", "base", "novel")]
    splits += [
        (f"coco14_trainval_{prefix}_{shot}shot_seed{seed}",
         "coco/trainval2014", "")
        for prefix in ("all", "novel")
        for shot in (1, 2, 3, 5, 10, 30)
        for seed in range(10)
    ]
    meta = _get_builtin_metadata("coco_fewshot")
    for name, imgdir, annofile in splits:
        register_meta_coco(name, meta, os.path.join(root, imgdir),
                           os.path.join(root, annofile), root=root)
    return [name for name, _, _ in splits]


def register_all_voc(root="datasets"):
    meta = _get_builtin_metadata("voc_fewshot")
    names = []
    for name, dirname, split, keepclasses, sid in (
        _voc_static_splits() + _voc_fewshot_splits()
    ):
        year = 2007 if "2007" in name else 2012
        register_meta_voc(
            name, meta, os.path.join(root, dirname), split, year,
            keepclasses, sid, root=root,
        )
        names.append(name)
    return names


def register_all(root="datasets"):
    """Register every built-in name under ``root``; a later call with
    another root registers them again there."""
    global _registered_root, _registered_names
    if _registered_root == root:
        return
    for name in _registered_names:
        DatasetCatalog.remove(name)
    _registered_root, _registered_names = None, []
    names = register_all_coco(root) + register_all_voc(root)
    _registered_root, _registered_names = root, names
