from .build import (
    build_gradient_clipper,
    build_lr_scheduler,
    build_optimizer,
    build_scheduler,
    clip_each_param_norm_,
    frozen_prefixes,
    lr_multiplier,
    param_groups,
)

__all__ = [
    "build_gradient_clipper",
    "build_lr_scheduler",
    "build_optimizer",
    "build_scheduler",
    "clip_each_param_norm_",
    "frozen_prefixes",
    "lr_multiplier",
    "param_groups",
]
