"""Weights for the PyTorch port: carried across from the JAX package's flax
parameter tree, or initialised from a seed.

``state_dict_from_jax_params`` is this package's own copy of the JAX
package's ``checkpoint/torch_import.py`` mapping (``_ours_to_d2`` and
``_deconvert``): flax paths -> detectron2 state-dict names, with HWIO ->
OIHW convolutions, (in, out) -> (out, in) linears and (C,) -> (1, C, 1, 1)
affines. The text branches' parameters keep their flax paths as names
(``roi_heads.attention.attention.w_q.weight``, ``roi_heads.mlp_adapter.0``
for flax's ``layers_0``, ``pixel_attention.ffn.norm3.weight`` for a
LayerNorm's ``scale``, ``bg_feature``). ``init_weights`` gives a model the
JAX package's initialisers, drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_INV_MOD = {
    "conv1": ("conv1", None),
    "conv2": ("conv2", None),
    "conv3": ("conv3", None),
    "bn1": ("conv1", "norm"),
    "bn2": ("conv2", "norm"),
    "bn3": ("conv3", "norm"),
    "shortcut": ("shortcut", None),
    "shortcut_bn": ("shortcut", "norm"),
}


# the text branches' modules: at the top of the meta-arch, and in the ROI
# head (its box_predictor has the flagship's names)
_TEXT_TOP = ("bg_feature", "sem2vis_proj", "vis2sem_res2", "vis2sem_res3",
             "vis2sem_res4", "to_rpn_input_proj", "LtoVproj", "attproj",
             "pixel_attention")
_TEXT_ROI = ("attention", "mlp_adapter", "stu_box_predictor",
             "output_projection")


def _text_path_to_name(p):
    """A text-branch flax path -> (name, kind): the path joined with dots,
    ``layers_N`` (flax ``nn.Sequential``) -> ``N``, a Dense ``kernel`` ->
    ``weight`` (transposed), a LayerNorm ``scale`` -> ``weight``."""
    parts = [re.sub(r"^layers_(\d+)$", r"\1", x) for x in p]
    if parts[-1] == "kernel":
        return ".".join(parts[:-1] + ["weight"]), "linear"
    if parts[-1] == "scale":
        return ".".join(parts[:-1] + ["weight"]), "plain"
    return ".".join(parts), "plain"


def jax_path_to_d2(path):
    """Flattened flax path -> (this package's state-dict name, kind): the
    detectron2 name, or the text branches' own; (None, None) for a path
    with no name here."""
    p = tuple(map(str, path))
    if p[0] in _TEXT_TOP or (len(p) > 2 and p[0] == "roi_heads"
                             and p[1] in _TEXT_ROI):
        return _text_path_to_name(p)
    if p == ("backbone", "stem_conv1", "kernel"):
        return "backbone.stem.conv1.weight", "conv"
    if len(p) == 3 and p[:2] == ("backbone", "stem_bn1"):
        return "backbone.stem.conv1.norm." + p[2], "bn"

    def res_block(prefix, block, mod, leaf):
        conv, norm = _INV_MOD.get(mod, (None, None))
        if conv is None or not block.startswith("block"):
            return None, None
        b = block[len("block"):]
        if norm:
            return f"{prefix}.{b}.{conv}.norm.{leaf}", "bn"
        if leaf != "kernel":
            return None, None
        return f"{prefix}.{b}.{conv}.weight", "conv"

    if len(p) == 5 and p[0] == "backbone" and p[1].startswith("res"):
        return res_block(f"backbone.{p[1]}", p[2], p[3], p[4])
    if len(p) == 6 and p[:3] == ("roi_heads", "res5", "res5"):
        return res_block("roi_heads.res5", p[3], p[4], p[5])
    if len(p) == 3 and p[0] == "rpn_head" and p[1] in (
        "conv", "objectness_logits", "anchor_deltas"
    ):
        base = f"proposal_generator.rpn_head.{p[1]}"
        if p[2] == "kernel":
            return base + ".weight", "conv"
        if p[2] == "bias":
            return base + ".bias", "plain"
    if len(p) == 4 and p[0] == "roi_heads" \
            and p[1] in ("box_predictor", "cls_predictor") \
            and p[2] in ("cls_score", "bbox_pred"):
        base = f"roi_heads.{p[1]}.{p[2]}"
        if p[3] == "kernel":
            return base + ".weight", "linear"
        if p[3] == "bias":
            return base + ".bias", "plain"
    if len(p) == 4 and p[0] == "roi_heads" \
            and p[1] in ("box_head", "cls_head") \
            and re.fullmatch(r"(conv|fc)\d+", p[2]):
        base = f"roi_heads.{p[1]}.{p[2]}"
        if p[3] == "bias":
            return base + ".bias", "plain"
        if p[3] == "kernel":
            kind = "conv" if p[2].startswith("conv") else "linear"
            return base + ".weight", "fc_first" if p[2] == "fc1" else kind
    if len(p) == 2 and p[0] in ("affine_rpn", "affine_rcnn"):
        return f"{p[0]}.{p[1]}", "affine"
    return None, None


def _to_torch_layout(value: np.ndarray, kind: str,
                     first_fc_channels: int = 0) -> np.ndarray:
    v = np.asarray(value, np.float32)
    if kind == "fc_first":
        # flax flattens the pooled map (P, P, C), torch (C, P, P)
        c = first_fc_channels
        p = math.isqrt(v.shape[0] // c)
        return v.reshape(p, p, c, -1).transpose(3, 2, 0, 1).reshape(
            v.shape[1], c * p * p)
    if kind == "conv":
        return v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if kind == "linear":
        return v.T  # (in, out) -> (out, in)
    if kind == "affine":
        return v.reshape(1, -1, 1, 1)  # (C,) -> (1, C, 1, 1)
    return v


def _flatten(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _first_fc_channels(params: Mapping, tower: str) -> int:
    """Channels of the map a StandardROIHeads tower's first fc flattens:
    its last conv's, else res4's (the RPN conv's input)."""
    convs = sorted((k for k in params["roi_heads"][tower]
                    if k.startswith("conv")), key=lambda k: int(k[4:]))
    if convs:
        return np.shape(params["roi_heads"][tower][convs[-1]]["kernel"])[-1]
    return np.shape(params["rpn_head"]["conv"]["kernel"])[2]


def state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """The flax param tree of a JAX meta-arch (nested dicts of numpy
    arrays) -> this package's ``state_dict`` (float32 tensors). Raises on a
    parameter that has no name here."""
    state, unknown = {}, []
    for path, value in _flatten(params):
        name, kind = jax_path_to_d2(path)
        if name is None:
            unknown.append("/".join(map(str, path)))
            continue
        c = _first_fc_channels(params, path[1]) if kind == "fc_first" else 0
        state[name] = torch.from_numpy(
            np.array(_to_torch_layout(value, kind, c), order="C"))
    if unknown:
        raise ValueError(f"parameters with no PyTorch name: {unknown}")
    return state


def _he_fan_out_(w: torch.Tensor, gen: torch.Generator):
    """flax ``variance_scaling(2.0, "fan_out", "truncated_normal")``: a
    normal truncated at +-2 std, rescaled to variance 2 / fan_out."""
    fan_out = w.shape[0] * math.prod(w.shape[2:])
    std = math.sqrt(2.0 / fan_out) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator):
    """flax's default Dense and Conv draw (``lecun_normal``): a normal
    truncated at +-2 std, rescaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / math.prod(w.shape[1:])) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


# weights of the text meta-archs and heads that flax draws with its default
# Dense initialiser (the attention modules draw their own)
_LECUN = re.compile(r"(^|\.)(mlp_adapter\.\d+|output_projection|sem2vis_proj"
                    r"|vis2sem_res\d|to_rpn_input_proj|LtoVproj|attproj"
                    r"|(box|cls)_head\.(conv|fc)\d+)\.weight$")


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initialisers, drawn from ``generator``: first each
    attention module's own (``init_params_``, models/attention.py), then in
    parameter order He fan-out truncated normal for backbone and res5
    convolutions, zeros for each block's conv3 (so a random deep ResNet with
    identity FrozenBN stays bounded), N(0, 0.01) for the RPN head and the
    class scores, N(0, 0.001) for the box deltas, flax's lecun normal for
    the text heads' and meta-archs' other linears, N(0, 1) for
    ``bg_feature``, zero biases, and identity FrozenBN and affine layers."""
    done = set()
    for module in model.modules():
        own = [id(p) for p in module.parameters()]
        if hasattr(module, "init_params_") and not done.intersection(own):
            module.init_params_(generator)
            done.update(own)
    for name, param in model.named_parameters():
        if id(param) in done:
            continue
        if name.endswith(".bias"):
            param.zero_()
        elif name.startswith("affine_"):
            param.fill_(1.0)
        elif name == "bg_feature":
            nn.init.normal_(param, 0.0, 1.0, generator=generator)
        elif _LECUN.search(name):
            _lecun_normal_(param, generator)
        elif name.endswith("conv3.weight"):
            param.zero_()
        elif name.startswith("proposal_generator.") or \
                name.endswith("cls_score.weight"):
            nn.init.normal_(param, 0.0, 0.01, generator=generator)
        elif name.endswith("bbox_pred.weight"):
            nn.init.normal_(param, 0.0, 0.001, generator=generator)
        elif param.dim() == 4:
            _he_fan_out_(param, generator)
        else:
            raise ValueError(f"init_weights: no initialiser for {name}")
    for name, buf in model.named_buffers():
        if name.endswith(("norm.weight", "norm.running_var")):
            buf.fill_(1.0)
        elif name.endswith(("norm.bias", "norm.running_mean")):
            buf.zero_()
    return model
