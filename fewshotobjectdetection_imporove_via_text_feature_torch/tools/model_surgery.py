"""Checkpoint surgery on the command line, with the interface of the
repository's ``tools/model_surgery.py`` (remove / randinit / reset /
reset_student), over ``checkpoint/surgery.py``:

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.model_surgery \\
        --dataset voc --method randinit \\
        --src-path out/base1/model_final.pth --save-dir out/base1

The source is a checkpoint of this package or of detectron2 (``.pth``,
tensors or numpy arrays under ``"model"`` or bare) or a JAX package pickle
checkpoint (``.ckpt``); the result is a ``.pth``
(``<save-dir>/<tar-name>_surgery.pth`` for randinit, ``_remove`` for
remove, ``_optimizer`` for reset, ``_student`` for reset_student, which
draws a text head's student branch afresh) holding the model weights and
iteration 0.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..checkpoint import (
    load_jax_checkpoint,
    load_torch_state,
    reset_optimizer,
    surgery_randinit,
    surgery_remove,
)
from ..checkpoint.surgery import surgery_reset_student


def load_state(path: str):
    """A checkpoint's model weights as {"model": state dict, ...}."""
    if path.endswith(".ckpt"):
        return {"model": load_jax_checkpoint(path), "iteration": 0}
    if path.endswith(".pth"):
        return {"model": {k: torch.as_tensor(v) for k, v in
                          load_torch_state(path).items()}, "iteration": 0}
    raise SystemExit(f"{path}: surgery reads a .pth (this package's or "
                     "detectron2's) or a JAX package .ckpt")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", default="coco", choices=["voc", "coco"])
    p.add_argument("--src-path", default="",
                   help="Path to the main checkpoint")
    p.add_argument("--save-dir", required=True)
    p.add_argument("--method",
                   choices=["remove", "randinit", "reset", "reset_student"],
                   required=True)
    p.add_argument("--tar-name", default="model_reset")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    os.makedirs(args.save_dir, exist_ok=True)
    state = reset_optimizer(load_state(args.src_path))
    if args.method == "reset":
        suffix = "_optimizer"
    elif args.method == "reset_student":
        state["model"], n = surgery_reset_student(state["model"],
                                                  seed=args.seed)
        print(f"re-randomized {n} student-branch tensors")
        suffix = "_student"
    elif args.method == "remove":
        state["model"] = surgery_remove(state["model"])
        suffix = "_remove"
    else:
        state["model"] = surgery_randinit(
            state["model"], 80 if args.dataset == "coco" else 20,
            dataset=args.dataset, seed=args.seed)
        suffix = "_surgery"
    path = os.path.join(args.save_dir, args.tar_name + suffix + ".pth")
    torch.save(state, path)
    print(f"save changed ckpt to {path}")
    return path


if __name__ == "__main__":
    main()
