"""Self-contained yacs-style config system (the PyTorch port's own copy).

A CfgNode with ``_BASE_`` YAML inheritance, a strict, type-checked merge
and detectron2's VERSION converter (``compat.py``): the part of fvcore's
CfgNode that loading configs needs, without the fvcore/yacs dependency.
defaults.py holds the complete schema, with the JAX package's key names.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any

import yaml

from .compat import (
    LATEST_VERSION,
    downgrade_config,
    guess_version,
    prune_removed_keys,
    upgrade_config,
)

_BASE_KEY = "_BASE_"


class CfgNode(dict):
    """dict with attribute access, deep merge, and YAML loading."""

    def __init__(self, init_dict: dict | None = None):
        init_dict = init_dict or {}
        super().__init__()
        for k, v in init_dict.items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no key {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(value, CfgNode) else value

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    # -- merging ---------------------------------------------------------
    def merge_from_file(self, cfg_filename: str) -> None:
        """Strict merge of a YAML file and its ``_BASE_`` chain, through
        fvcore's compat flow (``compat.py``): prune the keys this schema
        removed (any VERSION), guess the VERSION of a file that states
        none, and for an older version downgrade the full defaults to it,
        merge the file there (strict in the old key space), then upgrade
        the merged whole back to the latest. A VERSION above the latest
        raises ``ValueError``, an unknown key ``KeyError``."""
        loaded = prune_removed_keys(_load_yaml_with_base(cfg_filename))
        version = loaded.get("VERSION")
        if version is None:
            version = guess_version(loaded, cfg_filename)
        if version == LATEST_VERSION:
            _merge(loaded, self)
            return
        # a VERSION above the latest raises here
        old_self = CfgNode(downgrade_config(self.clone(), to_version=version))
        _merge(loaded, old_self)
        # upgrade(downgrade(defaults)) == defaults, so every key of the
        # upgraded whole exists here; merging it back coerces the types
        _merge(upgrade_config(old_self), self)

    def merge_from_list(self, opts: list) -> None:
        """Command-line overrides ``KEY VALUE ...``: each key must exist,
        and each value is parsed against its default's type."""
        if len(opts) % 2:
            raise ValueError(f"Override list has odd length: {opts}")
        for full_key, v in zip(opts[0::2], opts[1::2]):
            node = self
            parts = full_key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {full_key}")
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"Non-existent config key: {full_key}")
            node[parts[-1]] = _coerce(v, node[parts[-1]])

    # -- io ----------------------------------------------------------------
    def dump(self) -> str:
        return yaml.safe_dump(_to_plain(self), default_flow_style=None)


def _to_plain(node):
    if isinstance(node, CfgNode):
        return {k: _to_plain(v) for k, v in node.items()}
    if isinstance(node, tuple):
        return list(node)
    return node


def _merge(src: dict, dst: CfgNode) -> None:
    for k, v in src.items():
        if k == _BASE_KEY:
            continue
        if k not in dst:
            raise KeyError(f"Non-existent config key: {k}")
        if isinstance(v, dict) and isinstance(dst[k], CfgNode):
            _merge(v, dst[k])
        else:
            dst[k] = _coerce_merged(v, dst[k])


def _deep_tuple(v: Any) -> Any:
    if isinstance(v, (list, tuple)):
        return tuple(_deep_tuple(x) for x in v)
    return v


def _coerce_merged(new: Any, old: Any) -> Any:
    # YAML gives lists; keep tuples as tuples when the default was a
    # tuple — recursively, so nested defaults like ANCHOR_GENERATOR.SIZES
    # (((32, 64, ...),)) keep their type through dump -> reload cycles
    if isinstance(old, tuple) and isinstance(new, (list, tuple)):
        return _deep_tuple(new)
    if isinstance(new, str):
        return _coerce(new, old)
    return new


def _coerce(v: str, old: Any) -> Any:
    """Parse a YAML string value against the default's type.

    Type mismatches RAISE like yacs's _check_and_coerce_cfg_value_type:
    a string such as 'false' for a bool key must not be stored as a truthy
    string."""
    if not isinstance(v, str):
        return v
    try:
        parsed = ast.literal_eval(v)
    except (ValueError, SyntaxError):
        parsed = v
    if isinstance(old, tuple) and isinstance(parsed, (list, tuple)):
        return tuple(parsed)
    if isinstance(old, bool):
        if isinstance(parsed, (bool, int)):
            return bool(parsed)
        if isinstance(parsed, str) and parsed.lower() in ("true", "false"):
            return parsed.lower() == "true"
        raise ValueError(f"Cannot interpret {v!r} as a bool override")
    if (
        isinstance(parsed, str)
        and old is not None
        and not isinstance(old, str)
    ):
        raise ValueError(
            f"Cannot interpret override {v!r} for a "
            f"{type(old).__name__}-typed config value"
        )
    return parsed


def _load_yaml_with_base(filename: str) -> dict:
    with open(filename) as f:
        cfg = yaml.safe_load(f) or {}
    base = cfg.pop(_BASE_KEY, None)
    if base:
        if not os.path.isabs(base):
            base = os.path.join(os.path.dirname(filename), base)
        base_cfg = _load_yaml_with_base(base)
        _merge_plain(cfg, base_cfg)
        return base_cfg
    return cfg


def _merge_plain(src: dict, dst: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge_plain(v, dst[k])
        else:
            dst[k] = v


def get_cfg() -> CfgNode:
    from .defaults import _C

    return _C.clone()
