"""Trainer hooks: periodic evaluation during training, counterpart of the
JAX package's ``engine/hooks.py`` (ref defrcn/engine/hooks.py:15-83
EvalHookDeFRCN: inference/iter_*.json every period, res_final.json at the
end)."""

from __future__ import annotations

import json
import logging
import os
from typing import Callable

from ..utils.events import flatten_results_dict

logger = logging.getLogger(__name__)


class EvalHook:
    """Runs ``eval_fn()`` every ``period`` iterations and at the last one;
    a ``Trainer`` hook, called with the iteration after each step."""

    def __init__(self, period: int, max_iter: int, output_dir: str,
                 eval_fn: Callable):
        self.period = period
        self.max_iter = max_iter
        self.output_dir = output_dir
        self.eval_fn = eval_fn

    def __call__(self, iteration: int):
        is_final = iteration == self.max_iter - 1
        if not (is_final or (self.period > 0
                             and (iteration + 1) % self.period == 0)):
            return
        results = self.eval_fn()
        flat = {}
        for k, v in flatten_results_dict(results).items():
            try:
                flat[k] = float(v)
            except (TypeError, ValueError):
                pass
        out_dir = os.path.join(self.output_dir, "inference")
        os.makedirs(out_dir, exist_ok=True)
        name = "res_final.json" if is_final else f"iter_{iteration:07d}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(flat, f)
        logger.info("EvalHook iter %d: %s", iteration, flat)
