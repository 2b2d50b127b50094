"""The program's spans in a traced run of the evaluation cell, on the card;
the benchmark's own runs never call this.

  python3 benchmark/tools/spans_look.py --workload voc_r101.infer_b32 \\
      --seed 1 [--seconds 51]

runs the cell once with ``--trace 1``, as ``benchmark/run.py`` does, and
prints that run's result line; then one JSON line of the span readings
(``harness/spans.py``) of the same traced window: each model stage's self
device ms an image, the idle ms a batch under each span, the blocking
runtime calls inside the forward, the share of the window's idle time
inside some span, the ten longest idle gaps labelled by span, and the
run's per-layer metrics (the hook ranges') beside them.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[2])]

from harness import core, spans, trace  # noqa: E402


@contextlib.contextmanager
def keeping_events(kept: list):
    """While open, each trace that ``trace.read_trace`` reads is also
    appended to ``kept``; the readings are its own."""
    read = trace.read_trace

    def reading(events):
        kept.append(events)
        return read(events)

    trace.read_trace = reading
    try:
        yield kept
    finally:
        trace.read_trace = read


def look(reading: dict, images: int, line: dict) -> dict:
    """The span readings of one traced window beside the run's own."""
    batches = reading["count"].get("eval.forward", 0)
    per_batch = {n: 1e3 * v / batches
                 for n, v in reading["self_idle_s"].items()} if batches else {}
    run = {n: m["value"] for n, m in line.get("metrics", {}).items()}
    out = {
        "metrics": spans.infer_metrics(reading, images),
        "idle_attributed_share": spans.attributed_share(reading),
        "idle_ms_per_batch": 1e3 * reading["idle_s"] / batches
        if batches else None,
        "self_idle_ms_per_batch": per_batch,
        "self_device_ms_per_image": {
            n: 1e3 * v / images
            for n, v in reading["self_device_s"].items()},
        "idle_outside_ms_per_batch": {
            k: 1e3 * v / batches
            for k, v in reading["idle_outside_where_s"].items()}
        if batches else {},
        "syncs_per_batch": {n: v / batches
                            for n, v in reading["syncs"].items()}
        if batches else {},
        "span_count": reading["count"],
        "gaps": reading["gaps"],
        "run_metrics": run,
        "device": line.get("device"),
    }
    m = out["metrics"]
    if "backbone_span_ms.infer" in m and run.get("backbone_ms.infer"):
        out["backbone_span_over_hook"] = (m["backbone_span_ms.infer"]
                                          / run["backbone_ms.infer"])
    heads = [m.get(f"{s}_span_ms.infer")
             for s in ("rpn", "roi_heads", "detections")]
    hook_heads = [run.get("rpn_ms.infer"), run.get("roi_heads_ms.infer")]
    if None not in heads and None not in hook_heads:
        out["heads_span_over_hook"] = sum(heads) / sum(hook_heads)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    a = p.parse_args(argv)
    from harness.main import main as run_cell

    cell = core.find_cell(core.load_spec(), a.workload)
    traffic = cell["traffic"]
    images = traffic["trace_batches"] * traffic["batch"]
    kept, out = [], io.StringIO()
    with keeping_events(kept), contextlib.redirect_stdout(out):
        rc = run_cell(["--workload", a.workload, "--seed", str(a.seed),
                       "--seconds", str(a.seconds), "--trace", "1"])
    print(out.getvalue(), end="", flush=True)
    if rc or not kept:
        return rc or 1
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    result = look(spans.read(kept[-1]), images, line)
    result.update(workload=a.workload, seed=a.seed)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
