"""The program's configuration and model for a cell: the configuration
file's YAML layers over the program's defaults, and the model built on the
card with the weights the benchmark draws from the seed."""

from __future__ import annotations

import os
import tempfile

import torch

from .weights import draw_state


def build_cfg(config: dict, output_dir: str, extra_opts=()):
    """The program's configuration: its defaults, the configuration file's
    YAML layers in order, its run options, then ``extra_opts``."""
    import yaml

    from fewshotobjectdetection_imporove_via_text_feature_torch.config \
        import get_cfg

    cfg = get_cfg()
    with tempfile.TemporaryDirectory() as tmp:
        for i, layer in enumerate(config["yaml_layers"]):
            path = os.path.join(tmp, f"layer{i}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(layer, f)
            cfg.merge_from_file(path)
    cfg.merge_from_list([*config["run_opts"], "OUTPUT_DIR", output_dir,
                         "TPU.COMPUTE_DTYPE", config["compute_dtype"],
                         *extra_opts])
    return cfg


def build_model(cfg, device):
    """The program's model for ``cfg`` on ``device`` (parameters float32),
    before any weights are loaded."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.models \
        import build_model as port_build

    with torch.device(device):
        return port_build(cfg)


def state_shapes(model) -> dict:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def seeded_state(model, config: dict, seed: int, device) -> dict:
    """The configuration's weights drawn from ``seed`` for every tensor of
    the model's state dict, by detectron2's names."""
    rules = [(p, r) for p, r in config["weights"]]
    return draw_state(state_shapes(model), rules, seed, device)


def load_state(model, state: dict) -> None:
    """Every tensor of the model's state dict from ``state``."""
    model.load_state_dict(state, strict=True)
