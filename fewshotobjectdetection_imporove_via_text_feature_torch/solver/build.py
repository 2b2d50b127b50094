"""Optimizer, LR schedule and gradient clipping of the training step.

Counterpart of the JAX package's ``solver/build.py`` (detectron2's
``build_optimizer`` and ``lr_scheduler.py``): SGD with momentum over three
parameter groups (regular: BASE_LR and WEIGHT_DECAY; bias: BASE_LR *
BIAS_LR_FACTOR and WEIGHT_DECAY_BIAS; norm: WEIGHT_DECAY_NORM), an
iteration-based WarmupMultiStepLR or WarmupCosineLR with linear or constant
warmup, and per-tensor norm or value clipping.

The JAX package runs one optax chain: clip -> decayed weights per group ->
trace (momentum) -> bias LR factor -> -lr -> zero for frozen parameters.
``torch.optim.SGD`` with dampening 0 does the same per group: it adds the
decay to the (clipped) gradient, folds it into the momentum buffer, and
steps by the group's lr, which carries the bias factor. Frozen parameters
(the stages below FREEZE_AT, RPN.FREEZE, ROI_HEADS.FREEZE_FEAT,
ADDITION.FREEZEATTENTION; FrozenBN statistics and affines are buffers here)
are in no group, so neither the step nor the decay ever moves them; the
gradient still flows through them to what lies below. The attention FFN's
LayerNorm is a live norm module: the "norm" group.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def lr_multiplier(cfg):
    """step -> the LR as a multiple of SOLVER.BASE_LR: warmup times the
    multi-step decay or the cosine."""
    steps = tuple(cfg.SOLVER.STEPS)
    gamma = cfg.SOLVER.GAMMA
    warmup_iters = cfg.SOLVER.WARMUP_ITERS
    warmup_factor = cfg.SOLVER.WARMUP_FACTOR
    method = cfg.SOLVER.WARMUP_METHOD
    max_iter = cfg.SOLVER.MAX_ITER
    name = cfg.SOLVER.LR_SCHEDULER_NAME
    if name not in ("WarmupMultiStepLR", "WarmupCosineLR"):
        raise ValueError(f"Unknown LR scheduler: {name}")

    def warmup(step):
        if warmup_iters <= 0 or step >= warmup_iters:
            return 1.0
        if method == "constant":
            return warmup_factor
        alpha = min(max(step / warmup_iters, 0.0), 1.0)
        return warmup_factor * (1 - alpha) + alpha

    def multiplier(step):
        if name == "WarmupMultiStepLR":
            return warmup(step) * gamma ** sum(step >= s for s in steps)
        progress = min(max(step / max_iter, 0.0), 1.0)
        return warmup(step) * 0.5 * (1.0 + math.cos(math.pi * progress))

    return multiplier


def build_lr_scheduler(cfg):
    """step -> learning rate (a float)."""
    mult = lr_multiplier(cfg)
    return lambda step: cfg.SOLVER.BASE_LR * mult(step)


_NORM_TYPES = (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm, nn.SyncBatchNorm)


def frozen_prefixes(cfg):
    """Parameter-name prefixes the optimizer never updates."""
    backbone = cfg.MODEL.BACKBONE
    freeze_at = 4 if backbone.FREEZE else backbone.FREEZE_AT
    stages = ("backbone.stem.", "backbone.res2.", "backbone.res3.",
              "backbone.res4.")
    out = list(stages[:max(0, min(freeze_at, 4))])
    if cfg.MODEL.RPN.FREEZE:
        out.append("proposal_generator.")
    if cfg.MODEL.ROI_HEADS.FREEZE_FEAT:
        out.append("roi_heads.res5.")
    if cfg.MODEL.ADDITION.FREEZEATTENTION:
        # the parameters only (ref roi_heads.py:948-951): the gradient
        # still flows through the attention into res5 and the backbone
        out.append("roi_heads.attention.")
    return tuple(out)


def param_groups(cfg, model: nn.Module):
    """{"regular" | "bias" | "norm": [(name, parameter), ...]} of the
    trainable parameters; frozen ones are in none. As in detectron2 (and the
    JAX package), every parameter of a live norm module is in "norm", even
    its bias."""
    frozen = frozen_prefixes(cfg)
    norm_params = {id(p) for m in model.modules()
                   if isinstance(m, _NORM_TYPES) for p in m.parameters()}
    groups = {"regular": [], "bias": [], "norm": []}
    for name, p in model.named_parameters():
        if name.startswith(frozen):
            continue
        if id(p) in norm_params:
            groups["norm"].append((name, p))
        elif name.endswith(".bias"):
            groups["bias"].append((name, p))
        else:
            groups["regular"].append((name, p))
    return groups


def build_optimizer(cfg, model: nn.Module) -> torch.optim.SGD:
    """SGD with momentum over the three groups. Each group's ``lr`` is
    BASE_LR times ``lr_factor``; the scheduler multiplies it per step."""
    s = cfg.SOLVER
    settings = {
        "regular": (1.0, s.WEIGHT_DECAY),
        "bias": (s.BIAS_LR_FACTOR, s.WEIGHT_DECAY_BIAS),
        "norm": (1.0, s.WEIGHT_DECAY_NORM),
    }
    groups = []
    for kind, named in param_groups(cfg, model).items():
        if not named:
            continue
        factor, decay = settings[kind]
        groups.append({"params": [p for _, p in named], "name": kind,
                       "lr": s.BASE_LR * factor, "lr_factor": factor,
                       "weight_decay": decay})
    return torch.optim.SGD(groups, lr=s.BASE_LR, momentum=s.MOMENTUM,
                           dampening=0.0, nesterov=s.NESTEROV)


def build_scheduler(cfg, optimizer):
    """LambdaLR over ``lr_multiplier``: each group's lr is its initial lr
    (BASE_LR x its factor) times the multiplier of the step; ``state_dict``
    carries the step for resume."""
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lr_multiplier(cfg))


def clip_each_param_norm_(params, max_norm: float, norm_type: float = 2.0):
    """Clip each gradient's own norm to ``max_norm`` (detectron2 registers
    every parameter as its own group, so each tensor is clipped alone):
    g *= min(1, max_norm / (norm + 1e-6)), the norm taken in float32."""
    for p in params:
        if p.grad is None:
            continue
        g32 = p.grad.float()
        if math.isinf(norm_type):
            n = g32.abs().max()
        else:
            n = (g32.abs() ** norm_type).sum() ** (1.0 / norm_type)
        scale = torch.clamp(max_norm / (n + 1e-6), max=1.0)
        p.grad.copy_(g32 * scale)


def build_gradient_clipper(cfg):
    """params -> None, clipping their gradients in place as
    SOLVER.CLIP_GRADIENTS says, or None when clipping is off."""
    c = cfg.SOLVER.CLIP_GRADIENTS
    if not c.ENABLED:
        return None
    if c.CLIP_TYPE == "norm":
        return lambda params: clip_each_param_norm_(
            params, c.CLIP_VALUE, float(c.NORM_TYPE))
    if c.CLIP_TYPE == "value":
        return lambda params: torch.nn.utils.clip_grad_value_(
            params, c.CLIP_VALUE)
    raise ValueError(f"Unknown CLIP_TYPE {c.CLIP_TYPE!r}")
