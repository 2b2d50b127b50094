"""Weights drawn from the seed on the card, under detectron2's names, in
float32 (the program keeps float32 master weights and computes in the
configuration's dtype).

One normal draw of the total size fills every tensor, which is then scaled
by a rule of its name: convolutions and linears by their fan-in (He for
those a ReLU follows, LeCun for the others, times a gain for the output
layers), FrozenBN as an affine map (the stem's scaled to the pixels'
range, each block's last one damped so a 101-layer residual stack stays
bounded), the GDL affine layers as identity. The rules and their gains are
the configuration's ``weights`` entry, so the same draw is the same
function for the program and the reference.
"""

from __future__ import annotations

import math
import re

import torch


def _rule(name: str, rules: list):
    for pattern, rule in rules:
        if re.search(pattern, name):
            return rule
    raise KeyError(f"no weight rule matches {name!r}")


@torch.no_grad()
def draw_state(shapes: dict, rules: list, seed: int, device) -> dict:
    """``shapes`` (name -> shape) -> (name -> float32 tensor on
    ``device``), drawn from ``seed``. ``rules``: [(regex, rule)], the first
    match wins; a rule is {"kind": "he" | "lecun" | "normal" | "const" |
    "uniform", "gain" | "std" | "value" | "low", "high"}."""
    gen = torch.Generator(device=device).manual_seed(seed)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    unif = torch.rand(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        shape = tuple(shapes[name])
        z = flat[at:at + size].view(shape)
        u = unif[at:at + size].view(shape)
        at += size
        rule = _rule(name, rules)
        kind = rule["kind"]
        if kind in ("he", "lecun"):
            fan_in = math.prod(shape[1:])
            base = 2.0 if kind == "he" else 1.0
            t = z * (rule.get("gain", 1.0) * math.sqrt(base / fan_in))
        elif kind == "normal":
            t = z * rule["std"] + rule.get("mean", 0.0)
        elif kind == "uniform":
            t = rule["low"] + (rule["high"] - rule["low"]) * u
        elif kind == "const":
            t = torch.full(shape, float(rule["value"]), device=device)
        else:
            raise ValueError(f"unknown weight rule {kind!r} for {name}")
        out[name] = t.contiguous()
    return out
