"""The program's spans as ``harness/spans.py`` reads them: a hand-written
chrome trace with the benchmark's hook ranges, the program's ``fsod.``
spans, kernels, a copy, a set, runtime syncs and known idle gaps, each
reading counted by hand; ``trace.read_trace`` reads the same with and
without the spans; and a tiny traced evaluation on the CPU holds every
span the readers name."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from harness import infer, spans, trace
from tiny import args, tiny_infer_cell

US = 1e-6  # the trace's microseconds in seconds


def _x(cat, name, ts, end, **args):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
          "pid": 1, "tid": 1}
    if args:
        ev["args"] = args
    return ev


# the program's spans of one batch (microseconds), the loader's last fetch
SPANS = [("eval.fetch", 0, 55), ("eval.forward", 60, 500),
         ("normalize", 70, 100), ("backbone", 100, 300), ("branch", 300, 310),
         ("rpn", 310, 400), ("roi_heads", 400, 480),
         ("detections", 480, 500), ("eval.to_host", 500, 800),
         ("eval.collect", 800, 850), ("eval.fetch", 850, 900)]
# (correlation, launch time, device start, device end, category)
DEVICE = [(1, 20, 30, 50, "gpu_memcpy"),    # fetch
          (2, 65, 65, 75, "kernel"),        # the forward's own
          (3, 80, 80, 120, "kernel"),       # normalize
          (4, 110, 130, 250, "kernel"),     # backbone
          (5, 200, 250, 320, "kernel"),     # backbone
          (6, 305, 320, 330, "kernel"),     # branch
          (7, 320, 340, 360, "kernel"),     # rpn
          (8, 410, 420, 440, "gpu_memset"),  # roi_heads
          (9, 420, 440, 600, "kernel"),     # roi_heads
          (10, 490, 600, 620, "kernel"),    # detections
          (11, 505, 620, 630, "gpu_memcpy"),  # to_host
          (12, 870, 880, 890, "kernel")]    # the last fetch
IMAGES = 2


def _trace(with_spans=True):
    ev = [_x("user_annotation", "bench:window", 0, 1000),
          _x("user_annotation", "bench:backbone", 100, 300),
          _x("user_annotation", "bench:rpn", 310, 400),
          _x("user_annotation", "bench:roi_heads", 400, 500),
          _x("cpu_op", "aten::item", 650, 790),
          _x("cpu_op", "aten::_local_scalar_dense", 700, 780),
          # host calls that wait: one inside the forward, one in the
          # copies to the host, one after the batch; an asynchronous copy
          _x("cuda_runtime", "cudaStreamSynchronize", 350, 352),
          _x("cuda_runtime", "cudaMemcpy", 700, 790),
          _x("cuda_runtime", "cudaDeviceSynchronize", 950, 960)]
    for corr, launch, s, e, cat in DEVICE:
        call = "cudaMemcpyAsync" if cat == "gpu_memcpy" else (
            "cudaMemsetAsync" if cat == "gpu_memset" else "cudaLaunchKernel")
        ev.append(_x("cuda_runtime", call, launch, launch + 1,
                     correlation=corr))
        ev.append(_x(cat, f"k{corr}", s, e, correlation=corr))
    if with_spans:
        ev += [_x("user_annotation", "fsod." + n, s, e) for n, s, e in SPANS]
    return ev


def test_read_trace_reads_the_same_with_and_without_the_spans():
    with_spans, without = trace.read_trace(_trace()), trace.read_trace(
        _trace(with_spans=False))
    assert with_spans == without
    assert with_spans["busy_s"] == pytest.approx(510 * US)
    assert with_spans["by_range"] == pytest.approx(
        {"backbone": 190 * US, "rpn": 20 * US, "roi_heads": 200 * US})
    # (the seconds' rounding leaves a gap of 1e-19 s where two intervals meet)
    gaps = sorted(v for _, v in with_spans["breakdown"]["idle_gaps"]
                  if v > 1e-12)
    assert gaps == pytest.approx(
        sorted(x * US for x in (250, 110, 60, 30, 15, 10, 10, 5)))


def test_each_span_reads_its_hand_count():
    r = spans.read(_trace())
    assert r["count"] == {n: 2 if n == "eval.fetch" else 1
                          for n, _, _ in SPANS}
    # self time: the forward's own kernel alone; the stages' their own
    assert r["self_device_s"] == pytest.approx(
        {"eval.fetch": 30 * US, "eval.forward": 10 * US,
         "normalize": 40 * US, "backbone": 190 * US, "branch": 10 * US,
         "rpn": 20 * US, "roi_heads": 180 * US, "detections": 20 * US,
         "eval.to_host": 10 * US})
    assert r["idle_s"] == pytest.approx(490 * US)
    # idle to the innermost span: 55-60 and 900-1000 are in none
    assert r["self_idle_s"] == pytest.approx(
        {"eval.fetch": 75 * US, "eval.forward": 5 * US, "normalize": 5 * US,
         "backbone": 10 * US, "rpn": 50 * US, "roi_heads": 20 * US,
         "eval.to_host": 170 * US, "eval.collect": 50 * US})
    assert r["idle_within_s"]["eval.forward"] == pytest.approx(90 * US)
    assert r["idle_outside_s"] == pytest.approx(105 * US)
    assert r["idle_outside_where_s"] == pytest.approx(
        {"before": 0.0, "between": 5 * US, "after": 100 * US})
    assert spans.attributed_share(r) == pytest.approx(100 * (1 - 105 / 490))
    # the forward's sync, not the copy's to the host nor the one after
    assert r["syncs"] == {"eval.forward": 1, "rpn": 1, "eval.to_host": 1}
    labels = dict((round(v / US), k) for k, v in r["gaps"])
    assert labels[250] == "eval.to_host > aten::item > " \
                          "aten::_local_scalar_dense"
    assert labels[110] == spans.OUTSIDE
    assert labels[60] == "rpn"
    assert labels[30] == "eval.fetch"
    assert labels[5] == "normalize"


def test_the_evaluation_metrics_read_their_hand_counts():
    m = spans.infer_metrics(spans.read(_trace()), IMAGES)
    assert m == pytest.approx({
        "normalize_span_ms.infer": 0.040 / IMAGES,
        "backbone_span_ms.infer": 0.190 / IMAGES,
        "branch_span_ms.infer": 0.010 / IMAGES,
        "rpn_span_ms.infer": 0.020 / IMAGES,
        "roi_heads_span_ms.infer": 0.180 / IMAGES,
        "detections_span_ms.infer": 0.020 / IMAGES,
        "fetch_idle_ms.infer": 0.075,
        "launch_idle_ms.infer": 0.090,
        "drain_idle_ms.infer": 0.220,
        "forward_syncs.infer": 1.0})
    # the stages' sum equals the hook ranges' over the same work
    hooks = trace.read_trace(_trace())["by_range"]
    assert (m["rpn_span_ms.infer"] + m["roi_heads_span_ms.infer"]
            + m["detections_span_ms.infer"]) == pytest.approx(
        1e3 * (hooks["rpn"] + hooks["roi_heads"]) / IMAGES)


def test_a_trace_without_spans_reads_empty():
    r = spans.read(_trace(with_spans=False))
    assert r["count"] == {} and r["syncs"] == {}
    assert r["idle_outside_s"] == pytest.approx(r["idle_s"])
    assert spans.attributed_share(r) == pytest.approx(0.0)
    assert spans.infer_metrics(r, IMAGES) == {}


def test_a_traced_tiny_evaluation_holds_every_span_the_readers_name():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import spans_look

    cell = tiny_infer_cell()
    kept = []
    with spans_look.keeping_events(kept):
        out = infer.run(args(seconds=0.3, trace=1), cell, torch.device("cpu"))
    assert out["correct"]
    assert len(kept) == 1 and trace.read_trace(kept[0]) == out["ctx"]["trace"]
    r = spans.read(kept[0])
    batches = cell["traffic"]["trace_batches"]
    assert r["count"]["eval.forward"] == batches
    for name in spans.STAGES + ("eval.to_host", "eval.collect"):
        assert r["count"][name] == batches, name
    images = batches * cell["traffic"]["batch"]
    assert set(spans.infer_metrics(r, images)) == {
        f"{s}_span_ms.infer" for s in spans.STAGES} | {
        "fetch_idle_ms.infer", "launch_idle_ms.infer",
        "drain_idle_ms.infer", "forward_syncs.infer"}
