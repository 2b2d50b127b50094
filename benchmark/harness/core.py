"""What every run shares: the command line, the benchmark's own files found
by name, the card check, the cache directories, the check of loaded
modules, and the result line.

Everything is found from ``BENCHMARK.json`` at the root of the checkout: a
cell (``workloads``) names its configuration (``configs/<name>.json``
beside this package) and its traffic (``traffic/<name>.json``); each
per-layer metric is a reader in ``metrics/<name>.py``. Adding a cell, a
configuration, a mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

START = time.perf_counter()
BENCH = Path(__file__).resolve().parent.parent     # benchmark/
ROOT = BENCH.parent                                  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax",
             "fewshotobjectdetection_imporove_via_text_feature_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result: exit non-zero, print none."""


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_spec(root: Path = ROOT, pending: bool = False) -> dict:
    """``BENCHMARK.json``; with ``pending``, also the cells of
    ``benchmark/pending/*.json`` (each a fragment of its lists: cells
    kept for a later benchmark, which the tools and tests reach and a run
    of ``run.py`` never does)."""
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise RunError(f"{path} is missing")
    spec = json.loads(path.read_text())
    if pending:
        for extra in sorted((root / "benchmark" / "pending").glob("*.json")):
            part = json.loads(extra.read_text())
            for key in ("configs", "workloads", "end_to_end", "per_layer"):
                spec[key] = spec[key] + part.get(key, [])
    return spec


def find_cell(spec: dict, name: str, bench: Path = BENCH) -> dict:
    """The cell ``name`` with its configuration and traffic files read,
    and the metrics it reports: ``{"cell", "config", "traffic",
    "end_to_end", "per_layer"}``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[cell["config"]]
    config = json.loads((bench.parent / cfg_entry["file"]).read_text())
    traffic_path = bench / "traffic" / f"{cell['traffic']}.json"
    if not traffic_path.exists():
        raise RunError(f"traffic file {traffic_path} is missing")
    traffic = json.loads(traffic_path.read_text())

    def reports(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in spec["end_to_end"] if reports(m)]
    per_layer = [m for m in spec["per_layer"] if reports(m)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": per_layer}


def load_reader(metric_name: str, bench: Path = BENCH):
    """The ``read(ctx)`` function of ``metrics/<metric_name>.py``."""
    path = bench / "metrics" / f"{metric_name}.py"
    if not path.exists():
        raise RunError(f"no reader {path} for metric {metric_name!r}")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_cache_dirs(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so only
    a checkout's first run builds (the program's nvcc libraries already
    live under ``build/torch_kernels``)."""
    cache = root / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(cache / sub)
    # a library that would load JAX by itself is kept from it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def require_cards(count: int):
    """The card check: no CUDA, or fewer cards than the cell asks for, is
    an error, never a fall-back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is False: this benchmark "
                       "runs on an NVIDIA card only")
    if torch.cuda.device_count() < count:
        raise RunError(f"the cell asks for {count} cards, "
                       f"{torch.cuda.device_count()} are visible")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (the port's name begins with the latter's, so the whole
    top-level name is compared)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


class Phases:
    """The set-up's phases, each timed to a synchronize, for one line on
    standard error."""

    def __init__(self, device):
        self.device = device
        self.t = time.perf_counter()
        self.start = seconds_since_start()
        self.marks = []

    def mark(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.marks.append((name, now - self.t))
        self.t = now

    def report(self, setup_s: float) -> None:
        parts = [f"start {self.start:.2f}"] + [f"{n} {v:.2f}"
                                               for n, v in self.marks]
        print(f"set-up {setup_s:.2f} s: " + ", ".join(parts),
              file=sys.stderr)


def seconds_since_start() -> float:
    return time.perf_counter() - START


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed derived from the run's seed and ``tags``."""
    import numpy as np

    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, *tags]
    state = np.random.SeedSequence(words).generate_state(1, np.uint64)
    return int(state[0] >> 1)


def judge(values: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "rule"}}: each number of ``limits`` against
    its limit; a number passes at or under it."""
    return {n: {"value": values[n], "limit": limit, "rule": "value <= limit"}
            for n, limit in limits.items()}


def passes(check: dict) -> bool:
    """A compared number against its limit, by its rule."""
    if check["rule"] == "value >= limit":
        return check["value"] >= check["limit"]
    return check["value"] <= check["limit"]


def emit(result: dict, checks: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, and the result as the last line of standard output,
    with the checks under a key of their own that comes last."""
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"({c['rule']})", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
