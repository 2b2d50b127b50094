"""Import reference-format weights (Caffe2 ``.pkl``, detectron2 ``.pth``)
into this package's models.

Counterpart of the JAX package's ``checkpoint/torch_import.py`` (ref
defrcn/checkpoint/detection_checkpoint.py:23-56): ``MODEL.WEIGHTS`` may be a
Caffe2 ImageNet file (R-101.pkl), a detectron2 or this package's ``.pth``,
or a JAX package pickle checkpoint (``.ckpt``). This package's parameters
already carry detectron2 names in torch layouts (OIHW convolutions, (out, in)
linears, (1, C, 1, 1) affines), so a detectron2 name needs no conversion and
a Caffe2 blob only a new name:

  conv1_w / res_conv1_bn_{s,b}      -> backbone.stem.conv1.{weight,norm.*}
  res{S}_{B}_branch2{a,b,c}(_bn_*)  -> backbone.res{S}.{B}.conv{1,2,3}...
  res{S}_{B}_branch1(_bn_*)         -> backbone.res{S}.{B}.shortcut...
  res5_*                            -> roi_heads.res5.*

A Caffe2 ``_bn_s``/``_bn_b`` pair loads into FrozenBN's weight and bias; the
running statistics keep mean 0 and var 1, so the scale is w / sqrt(1 + 1e-5)
as in the JAX package (not detectron2's ``ones - eps`` convention).

The load is not strict: a name with no translation, no tensor in the model
(``stu_box_predictor`` in a model without a text head) or another shape (a
base ``cls_score`` into a novel model) is skipped and counted, and the
counts are logged. A text model loads the reference's
``roi_heads.stu_box_predictor.{cls_score,bbox_pred}`` under those names.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

logger = logging.getLogger(__name__)

_BRANCH = {"branch2a": "conv1", "branch2b": "conv2", "branch2c": "conv3"}


# what a weight pickle may name besides numpy: an ordered dict, and the
# bytes encoder that protocol-2 pickles of arrays use
_PICKLE_OK = {("collections", "OrderedDict"), ("_codecs", "encode")}


class _NumpyUnpickler(pickle.Unpickler):
    """Numpy arrays in plain containers, nothing else (unpickling a class
    can run its code)."""

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy" or (module, name) in _PICKLE_OK:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"a weight file holds no {module}.{name}")


def load_c2_pkl(path: str) -> Dict[str, np.ndarray]:
    """The blobs of a Caffe2 pickle (written by Python 2, so latin1), without
    the optimizer's ``_momentum`` blobs."""
    with open(path, "rb") as f:
        data = _NumpyUnpickler(f, encoding="latin1").load()
    if "blobs" in data:
        data = data["blobs"]
    return {k: np.asarray(v) for k, v in data.items()
            if not k.endswith("_momentum")}


def c2_to_d2(name: str) -> Optional[str]:
    """Caffe2 blob name -> this package's (detectron2) name, or None; the
    same cases, in the same order, as the JAX package's ``_c2_to_ours``."""
    if name == "conv1_w":
        return "backbone.stem.conv1.weight"
    if name in ("res_conv1_bn_s", "conv1_bn_s"):
        return "backbone.stem.conv1.norm.weight"
    if name in ("res_conv1_bn_b", "conv1_bn_b"):
        return "backbone.stem.conv1.norm.bias"
    parts = name.split("_")
    if not name.startswith("res") or len(parts) < 3:
        return None
    stage, block, branch = parts[:3]
    prefix = ("roi_heads.res5" if stage == "res5"
              else f"backbone.{stage}") + f".{block}"
    if branch == "branch1":
        conv = "shortcut"
    else:
        conv = _BRANCH.get(branch)
        if conv is None:
            return None
    if name.endswith("_bn_s"):
        return f"{prefix}.{conv}.norm.weight"
    if name.endswith("_bn_b"):
        return f"{prefix}.{conv}.norm.bias"
    return f"{prefix}.{conv}.weight"


def apply_weight_dict(model: nn.Module, named,
                      translate: Callable) -> Tuple[int, List[str]]:
    """Copy ``named`` (name -> array or tensor) into ``model``'s parameters
    and buffers under ``translate(name)``, in place. Returns (matched,
    skipped names)."""
    state = model.state_dict(keep_vars=True)
    matched, skipped = 0, []
    with torch.no_grad():
        for name, value in named.items():
            target = translate(name)
            if target is None or target not in state:
                skipped.append(name)
                continue
            value = torch.as_tensor(np.asarray(value)
                                    if not isinstance(value, torch.Tensor)
                                    else value)
            dst = state[target]
            if tuple(dst.shape) != tuple(value.shape):
                skipped.append(name)
                continue
            dst.copy_(value.to(dst.dtype))
            matched += 1
    return matched, skipped


def _numpy_globals():
    """What ``torch.load(weights_only=True)`` needs to read numpy arrays and
    scalars, under the names numpy 1 and numpy 2 pickle them."""
    try:
        from numpy._core import multiarray  # numpy >= 2
    except ImportError:
        from numpy.core import multiarray
    out = [np.ndarray, np.dtype, multiarray._reconstruct, multiarray.scalar]
    for mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
        out += [(multiarray._reconstruct, f"{mod}._reconstruct"),
                (multiarray.scalar, f"{mod}.scalar")]
    dtypes = getattr(np, "dtypes", None)
    if dtypes is not None:
        out += [getattr(dtypes, n) for n in dir(dtypes) if n.endswith("DType")]
    return out


def load_torch_state(path: str) -> Dict:
    """The state dict of a ``.pth``: its ``"model"`` entry, or the file
    itself when it is a bare state dict.

    The loader is ``torch.load(weights_only=True)`` with numpy's array and
    scalar classes allowed: detectron2 files converted from other formats
    hold numpy arrays, which ``weights_only`` alone refuses, while a plain
    ``weights_only=False`` load would run any code the file names."""
    with torch.serialization.safe_globals(_numpy_globals()):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model", ckpt)
    return {k: v for k, v in state.items()
            if isinstance(v, (torch.Tensor, np.ndarray, np.generic))}


def load_reference_weights(path: str, model: nn.Module):
    """Load ``path`` into ``model``: ``.pkl`` (Caffe2), ``.ckpt`` (a JAX
    package pickle checkpoint) or ``.pth`` (detectron2 or this package).
    Returns (matched, skipped names)."""
    if path.endswith(".pkl"):
        return apply_weight_dict(model, load_c2_pkl(path), c2_to_d2)
    # this package's names are detectron2's: a name translates to itself,
    # and one with no tensor in the model (stu_box_predictor without a text
    # head, num_batches_tracked) is skipped
    if os.path.isdir(path) or path.endswith(".ckpt"):
        from .checkpointer import load_jax_checkpoint

        return apply_weight_dict(model, load_jax_checkpoint(path), _same)
    return apply_weight_dict(model, load_torch_state(path), _same)


def _same(name: str) -> str:
    return name


def maybe_load_reference_weights(path: str, model: nn.Module) -> nn.Module:
    """``MODEL.WEIGHTS`` into ``model`` (nothing for ``""``); a missing file
    raises, as the reference's checkpointer does."""
    if not path:
        return model
    if not os.path.exists(path):
        # evaluating a random model because of a mistyped path is far worse
        # than failing
        raise FileNotFoundError(
            f"MODEL.WEIGHTS {path!r} does not exist. Set MODEL.WEIGHTS '' "
            "explicitly to train from scratch."
        )
    matched, skipped = load_reference_weights(path, model)
    logger.info("Loaded %d tensors from %s (%d unmatched)", matched, path,
                len(skipped))
    return model
