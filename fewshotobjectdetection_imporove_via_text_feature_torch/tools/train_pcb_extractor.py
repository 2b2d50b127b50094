"""Train PCB's torchvision-structured ResNet-101 as a classifier on GT crops
of a synthetic-class VOC tree, and write a torchvision-named ``.pth`` for
TEST.PCB_MODELPATH:

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.train_pcb_extractor \\
        --data-root DATASETS --out w.pth [--iters 200] [--size 64] \\
        [--batch 16] [--lr 1e-3] [--acc-floor 0.7] [--seed 0] [--device cpu]

Counterpart of the repository's ``tools/train_pcb_extractor.py``: the same
crops (each train-pool GT box of both years' trainval, PIL bilinear to
``--size``, at most 40 a class), PCB's own input normalization, the same
``RandomState(seed).choice`` batch draw, Adam at ``--lr`` (torch's
defaults equal optax's), and an exit with a message when the accuracy of
the last 10 steps is below ``--acc-floor``: a non-separable extractor
makes the held-out gate's PCB leg meaningless. The model is
``evaluation/archs.TorchvisionResNet(depth=101)`` from ``init_tv_weights``
(seed ``--seed``), trained on ``--device`` (CUDA unless ``cpu``).

The JAX package's FrozenBN holds its weight, bias, running mean and
running variance as parameters, so its Adam trains all four; the port's
FrozenBN holds them as buffers. So the training runs the model through
``torch.func.functional_call`` over a trainable copy of its whole state
dict (parameters and buffers), and every tensor of it is trained. The file
holds that state dict under the names of ``torchvision_r101_manifest()``
(522 tensors), which PCB loads by name.
"""

from __future__ import annotations

import argparse
import glob
import os
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch
import torch.nn.functional as F

from ..data.builtin_meta import PASCAL_VOC_ALL_CATEGORIES
from ..evaluation.archs import (
    TorchvisionResNet,
    init_tv_weights,
    torchvision_r101_manifest,
)

# PCB's evaluation-time normalization (evaluation/pcb.py _MEAN/_STD): the
# extractor trains on the input distribution it will see
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def collect_crops(data_root, size, limit_per_class=40):
    """(N, size, size, 3) uint8 crops, (N,) int32 labels and the class
    names, from the GT boxes of both years' trainval (the gate's train
    pool; the held-out VOC2007 test split is never read)."""
    from PIL import Image

    classes = list(PASCAL_VOC_ALL_CATEGORIES[1])
    cls_idx = {c: i for i, c in enumerate(classes)}
    per_class = {c: 0 for c in classes}
    xs, ys = [], []
    for year in ("VOC2007", "VOC2012"):
        split_f = os.path.join(
            data_root, year, "ImageSets", "Main", "trainval.txt"
        )
        if not os.path.exists(split_f):
            continue
        train_ids = {l.strip() for l in open(split_f) if l.strip()}
        for xml in sorted(
            glob.glob(os.path.join(data_root, year, "Annotations", "*.xml"))
        ):
            fid = os.path.splitext(os.path.basename(xml))[0]
            if fid not in train_ids:
                continue
            root = ET.parse(xml).getroot()
            img = None
            for obj in root.findall("object"):
                name = obj.find("name").text
                if name not in cls_idx or per_class[name] >= limit_per_class:
                    continue
                bb = obj.find("bndbox")
                x1, y1, x2, y2 = (
                    int(float(bb.find(k).text))
                    for k in ("xmin", "ymin", "xmax", "ymax")
                )
                if img is None:
                    img = Image.open(
                        os.path.join(data_root, year, "JPEGImages",
                                     fid + ".jpg")
                    ).convert("RGB")
                crop = img.crop((x1 - 1, y1 - 1, x2, y2)).resize(
                    (size, size), Image.BILINEAR
                )
                xs.append(np.asarray(crop, np.uint8))
                ys.append(cls_idx[name])
                per_class[name] += 1
    return np.stack(xs), np.array(ys, np.int32), classes


def normalize(xs):
    """uint8 NHWC crops -> PCB-normalized float32 NHWC, as the JAX tool
    computes them."""
    return (xs.astype(np.float32) / 255.0 - _MEAN) / _STD


def train_extractor(xs, ys, iters, batch, lr, seed, device, init_state=None,
                    eps=1e-8):
    """Adam (``lr``, ``eps``) on softmax cross-entropy over batches drawn by
    ``RandomState(seed).choice``. The model starts from ``init_state``
    (torchvision names) if given, else from ``init_tv_weights`` with a
    generator seeded ``seed``. Returns (trained state dict on ``device``,
    per-step accuracies, per-step losses)."""
    model = TorchvisionResNet(depth=101)
    init_tv_weights(model, torch.Generator().manual_seed(seed))
    if init_state is not None:
        model.load_state_dict(
            {k: torch.from_numpy(np.array(v)) for k, v in init_state.items()})
    model.to(device)
    # every FrozenBN leaf is trained, as the JAX package's parameters are
    state = {k: v.detach().clone().requires_grad_(True)
             for k, v in model.state_dict().items()}
    opt = torch.optim.Adam(list(state.values()), lr=lr, eps=eps)
    x = torch.from_numpy(normalize(xs)).permute(0, 3, 1, 2).contiguous()
    x = x.to(device)
    y = torch.from_numpy(ys.astype(np.int64)).to(device)
    rng = np.random.RandomState(seed)
    accs, losses = [], []
    for it in range(iters):
        idx = torch.from_numpy(rng.choice(len(xs), size=batch,
                                          replace=False)).to(device)
        xb, yb = x[idx], y[idx]
        logits, _ = torch.func.functional_call(model, state, (xb,))
        loss = F.cross_entropy(logits, yb)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        accs.append((logits.detach().argmax(-1) == yb).float().mean())
        losses.append(loss.detach())
        if it % 20 == 0 or it == iters - 1:
            print(f"iter {it}: loss {float(losses[-1]):.4f} "
                f"acc {float(accs[-1]):.3f}")
    accs = torch.stack(accs).cpu().tolist() if accs else []
    losses = torch.stack(losses).cpu().tolist() if losses else []
    return {k: v.detach() for k, v in state.items()}, accs, losses


def export_state(state):
    """The trained state dict as contiguous CPU tensors under its
    torchvision names: the manifest's 522."""
    return {k: v.detach().cpu().contiguous() for k, v in state.items()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--acc-floor", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {args.device!r} asked for, but CUDA is not available; "
            "pass --device cpu to run on the CPU")

    xs, ys, _ = collect_crops(args.data_root, args.size)
    print(f"{len(xs)} crops over {len(set(ys.tolist()))} classes")
    t0 = time.perf_counter()
    state, accs, losses = train_extractor(
        xs, ys, args.iters, args.batch, args.lr, args.seed, device)
    train_s = time.perf_counter() - t0

    final_acc = float(np.mean(accs[-10:]))
    print(f"final train accuracy (last 10 iters): {final_acc:.3f}")
    if final_acc < args.acc_floor:
        raise SystemExit(
            f"extractor did not learn: acc {final_acc:.3f} < "
            f"{args.acc_floor} — a non-separable extractor makes the "
            f"PCB-on gate leg meaningless"
        )
    out = export_state(state)
    if sorted(out) != sorted(torchvision_r101_manifest()):
        raise RuntimeError("the trained state dict does not carry the "
                           "torchvision R-101 names")
    torch.save(out, args.out)
    print(f"wrote {len(out)} tensors -> {args.out}")
    return dict(final_acc=final_acc, train_s=train_s, crops=len(xs),
                iters=args.iters, first_loss=losses[0], last_loss=losses[-1],
                tensors=len(out), device=str(device))


if __name__ == "__main__":
    main()
