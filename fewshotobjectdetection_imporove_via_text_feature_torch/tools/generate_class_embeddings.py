"""Write class-embedding files in the reference's on-disk layout,
``{root}/{glove,clip}/{class}.txt`` and ``background.txt``, one vector a
file, as ``utils/class_embedding.get_class_embed`` reads them:

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.generate_class_embeddings \\
        [--root datasets] [--model glove|clip] [--from-npz vectors.npz]

Counterpart of the repository's ``tools/generate_class_embeddings.py``: the
same class names (VOC's three splits, COCO's 80 and ``background``), the
same files, byte for byte. With ``--from-npz`` a class's vector comes from
the ``.npz`` (class name -> vector, real GloVe or CLIP vectors); every
other class gets the deterministic synthetic unit vector of
``_synthetic_embedding``, so that the text branch runs end to end.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.builtin_meta import COCO_THING_CATEGORIES, PASCAL_VOC_ALL_CATEGORIES
from ..utils.class_embedding import SEMANTIC_DIMS, _synthetic_embedding


def class_names():
    """Every class name a dataset of the registry uses, and background."""
    names = {"background"}
    for split in PASCAL_VOC_ALL_CATEGORIES.values():
        names.update(split)
    names.update(n for _, n in COCO_THING_CATEGORIES)
    return sorted(names)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default="datasets")
    p.add_argument("--model", default="glove", choices=["glove", "clip"])
    p.add_argument(
        "--from-npz", default="",
        help=".npz mapping class name -> vector (real embeddings)",
    )
    args = p.parse_args(argv)

    dim = SEMANTIC_DIMS[args.model]
    source = {}
    if args.from_npz:
        data = np.load(args.from_npz)
        source = {k: np.asarray(data[k]) for k in data.files}

    out_dir = os.path.join(args.root, args.model)
    os.makedirs(out_dir, exist_ok=True)
    names = class_names()
    for name in names:
        vec = source.get(name)
        if vec is None:
            vec = _synthetic_embedding(name, dim)
        if vec.shape != (dim,):
            raise SystemExit(f"{name}: a vector of shape {vec.shape}, "
                             f"{args.model} needs ({dim},)")
        np.savetxt(os.path.join(out_dir, f"{name}.txt"), vec)
    print(f"wrote {len(names)} embeddings to {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
