"""Write seeded stand-ins for the two ImageNet weight files the shipped
configs name, under their real tensor names, for runs without a download:

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_weights \\
        --c2 R-101.pkl --torchvision resnet101.pth [--seed 0] \\
        [--depth 101 --stem-out-channels 64 --res2-out-channels 256 \\
         --width-per-group 64]

``--c2``: a Caffe2 ImageNet ResNet-101 pickle as detectron2's model zoo
ships it (``MODEL.WEIGHTS`` of the base configs): ``{"blobs": {...}}`` with
``conv1_w``, ``res_conv1_bn_{s,b}``, ``res{2..5}_{B}_branch2{a,b,c}_w`` and
``_bn_{s,b}``, ``res{S}_0_branch1_*``, and the classifier ``pred_{w,b}``,
which a detector does not read. ``--torchvision``: the 522 tensors of
torchvision's resnet101-5d3b4d8f.pth (``TEST.PCB_MODELPATH``), a bare state
dict. The ``--depth`` and width options shape the ``--c2`` file for a
narrower detector (MODEL.RESNETS of a test config).

The numbers are drawn from ``--seed`` so that a deep ResNet stays bounded:
He-normal convolutions (fan in), BN scales near 1 except on the stem (1/50
of that, for raw pixels) and on each block's last convolution (0.05-0.2, as
a trained ResNet's are small there), small shifts. They test plumbing and numerics, not accuracy.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from ..models.backbone import RESNET_STAGES


def _conv(rng, cout, cin, k):
    std = np.sqrt(2.0 / (cin * k * k))
    return (rng.standard_normal((cout, cin, k, k)) * std).astype(np.float32)


def _scale(rng, c, last):
    lo, hi = (0.05, 0.2) if last else (0.8, 1.2)
    return rng.uniform(lo, hi, c).astype(np.float32)


def _shift(rng, c):
    return (rng.standard_normal(c) * 0.01).astype(np.float32)


def c2_resnet_blobs(seed: int = 0, depth: int = 101, stem_out: int = 64,
                    res2_out: int = 256, bottleneck: int = 64):
    """name -> array of a Caffe2 ImageNet ResNet (OIHW convolutions); the
    defaults are R-101's widths, the MODEL.RESNETS keys of a narrower
    detector give its own."""
    rng = np.random.RandomState(seed)
    # the stem's scales take out the spread of the raw pixels a Caffe2
    # model reads (mean-subtracted BGR, about 50), as a trained stem's do
    blobs = {"conv1_w": _conv(rng, stem_out, 3, 7),
             "res_conv1_bn_s": _scale(rng, stem_out, False) / 50.0,
             "res_conv1_bn_b": _shift(rng, stem_out)}
    cin = stem_out
    for i, n in enumerate(RESNET_STAGES[depth]):
        planes = bottleneck * 2**i
        cout = res2_out * 2**i
        for b in range(n):
            p = f"res{i + 2}_{b}"
            convs = [("branch2a", planes, cin if b == 0 else cout, 1),
                     ("branch2b", planes, planes, 3),
                     ("branch2c", cout, planes, 1)]
            if b == 0:
                convs.append(("branch1", cout, cin, 1))
            for branch, co, ci, k in convs:
                blobs[f"{p}_{branch}_w"] = _conv(rng, co, ci, k)
                blobs[f"{p}_{branch}_bn_s"] = _scale(rng, co,
                                                     branch == "branch2c")
                blobs[f"{p}_{branch}_bn_b"] = _shift(rng, co)
        cin = cout
    blobs["pred_w"] = (rng.standard_normal((1000, cin)) * 0.01).astype(
        np.float32)
    blobs["pred_b"] = np.zeros(1000, np.float32)
    return blobs


def write_c2_pkl(path: str, seed: int = 0, **widths) -> dict:
    blobs = c2_resnet_blobs(seed, **widths)
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    return blobs


def torchvision_r101_state(seed: int = 0):
    """name -> tensor of torchvision's ResNet-101 state dict, its 522
    tensors in manifest order."""
    import torch

    from ..evaluation.archs import TorchvisionResNet, torchvision_r101_manifest

    shapes = {k: tuple(v.shape)
              for k, v in TorchvisionResNet(101).state_dict().items()}
    rng = np.random.RandomState(seed)
    state = {}
    for name in torchvision_r101_manifest():
        shape = shapes[name]
        leaf = name.rsplit(".", 1)[-1]
        if name == "fc.weight":
            v = rng.standard_normal(shape) * 0.01
        elif name == "fc.bias":
            v = np.zeros(shape)
        elif len(shape) == 4:
            v = _conv(rng, shape[0], shape[1], shape[2])
        elif leaf == "weight":
            v = _scale(rng, shape[0], ".bn3." in name)
        elif leaf == "bias":
            v = _shift(rng, shape[0])
        elif leaf == "running_mean":
            v = rng.standard_normal(shape) * 0.05
        else:  # running_var
            v = rng.uniform(0.9, 1.1, shape)
        state[name] = torch.from_numpy(np.asarray(v, np.float32))
    return state


def write_torchvision_pth(path: str, seed: int = 0) -> dict:
    import torch

    state = torchvision_r101_state(seed)
    torch.save(state, path)
    return state


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--c2", default="", help="Caffe2 R-101 .pkl to write")
    p.add_argument("--torchvision", default="",
                   help="torchvision R-101 .pth to write")
    p.add_argument("--seed", type=int, default=0)
    # the --c2 file's ResNet, as MODEL.RESNETS names it (R-101 by default)
    p.add_argument("--depth", type=int, default=101)
    p.add_argument("--stem-out-channels", type=int, default=64)
    p.add_argument("--res2-out-channels", type=int, default=256)
    p.add_argument("--width-per-group", type=int, default=64)
    args = p.parse_args(argv)
    if args.c2:
        n = len(write_c2_pkl(
            args.c2, args.seed, depth=args.depth,
            stem_out=args.stem_out_channels,
            res2_out=args.res2_out_channels,
            bottleneck=args.width_per_group))
        print(f"wrote {n} Caffe2 blobs to {args.c2}")
    if args.torchvision:
        n = len(write_torchvision_pth(args.torchvision, args.seed))
        print(f"wrote {n} torchvision tensors to {args.torchvision}")


if __name__ == "__main__":
    main()
