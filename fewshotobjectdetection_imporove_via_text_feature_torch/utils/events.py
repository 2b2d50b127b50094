"""Metrics logging with the reference's observability contract, counterpart
of the JAX package's ``utils/events.py``: an "iter N" line on the log and a
metrics.json JSON-lines record per logged iteration (TensorBoard too when
it is installed), and the "copypaste:" CSV lines that
``tools/extract_results.py`` scrapes from OUTPUT_DIR/log.txt."""

from __future__ import annotations

import json
import logging
import os
from typing import Dict

logger = logging.getLogger("fsodtf_torch")


def _summary_writer(output_dir: str):
    """A TensorBoard ``SummaryWriter`` that does not load TensorFlow.
    ``torch.utils.tensorboard`` imports TensorFlow where it is installed
    (about 11 s a process on an 8-core CPU host), only to write files that
    tensorboard's own stub of the TF API writes alike. The module
    ``tensorboard.compat.notf`` is tensorboard's marker for that stub; it
    is set only while TensorFlow is not loaded already."""
    import sys
    import types

    if "tensorflow" not in sys.modules:
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
    from torch.utils.tensorboard import SummaryWriter

    return SummaryWriter(log_dir=output_dir)


class MetricsLogger:
    """stdout + metrics.json + (if available) TensorBoard: the reference's
    CommonMetricPrinter/JSONWriter/TensorboardXWriter trio."""

    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.json")
        try:
            self._tb = _summary_writer(output_dir)
        except ImportError:  # tensorboard is optional
            self._tb = None

    def log(self, iteration: int, scalars: Dict[str, float]):
        rec = {"iteration": iteration,
               **{k: float(v) for k, v in scalars.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k != "iteration":
                    self._tb.add_scalar(k, v, iteration)
        msg = "  ".join(
            f"{k}: {v:.4g}" for k, v in rec.items() if k != "iteration"
        )
        logger.info("iter %d  %s", iteration, msg)


def read_metrics(output_dir: str):
    """metrics.json's records under ``output_dir`` ([] when there is none);
    a torn last line (a write in progress) is left out."""
    path = os.path.join(output_dir, "metrics.json")
    if not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return rows


def print_csv_format(results: Dict[str, Dict[str, float]]):
    """The reference's copypaste contract (defrcn/evaluation/testing.py:
    7-23): per task, one 'copypaste:' line of metric names and one of
    values."""
    for task, res in results.items():
        logger.info("copypaste: Task: %s", task)
        logger.info("copypaste: %s", ",".join(res.keys()))
        logger.info(
            "copypaste: %s", ",".join(f"{v:.4f}" for v in res.values())
        )


def flatten_results_dict(results):
    out = {}
    for k, v in results.items():
        if isinstance(v, dict):
            for kk, vv in flatten_results_dict(v).items():
                out[f"{k}/{kk}"] = vv
        else:
            out[k] = v
    return out


def verify_results(cfg, results) -> bool:
    """The TEST.EXPECTED_RESULTS tolerance gate
    (defrcn/evaluation/testing.py:26-56); a missing metric fails it."""
    expected = cfg.TEST.EXPECTED_RESULTS
    if not expected:
        return True
    import math

    ok = True
    for task, metric, expected_val, tolerance in expected:
        actual = results.get(task, {}).get(metric)
        if actual is None:
            ok = False
            logger.error(
                "Result verification failed: %s/%s missing from results",
                task, metric,
            )
            continue
        if not math.isfinite(actual):
            ok = False
            logger.error(
                "Result verification failed: %s/%s is not finite (%r)",
                task, metric, actual,
            )
        elif abs(actual - expected_val) > tolerance:
            ok = False
            logger.error(
                "Result verification failed: %s/%s = %.4f (expected %.4f "
                "± %.4f)", task, metric, actual, expected_val, tolerance,
            )
    if ok:
        logger.info("Result verification passed.")
    return ok
