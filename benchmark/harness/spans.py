"""The program's own spans in a traced run: the ``fsod.`` ranges that the
port opens at its layer boundaries (its ``utils/tracing.py``), read from
the same chrome trace events as ``trace.read_trace`` and on the same clock
as the device's kernels, copies and sets and the host's runtime calls.

Spans nest by time. Each device interval is self time of the innermost
span open when its launch was made (the runtime call of the same
correlation id); each stretch of the traced window in which the device
ran nothing belongs to the spans open over it, and to the innermost for
self idle. Innermost is the open span that started last, on whatever
thread: the program opens its spans on one thread, and work that
autograd's thread launches belongs to the span open around it
(``train.backward``).

A trace without ``fsod.`` spans (a program that opens none) reads empty:
no span, all idle time outside the spans.
"""

from __future__ import annotations

from collections import Counter, defaultdict

from . import trace

PREFIX = "fsod."
# runtime calls that hold the host until the device has caught up; the
# asynchronous copy (cudaMemcpyAsync) is not among them
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
STAGES = ("normalize", "backbone", "branch", "rpn", "roi_heads",
          "detections")
OUTSIDE = "outside the program's spans"


def _events(events):
    """(window, spans, launches, device intervals, sync call times) of
    the events: spans as (start, end, name without the prefix)."""
    window = None
    spans, device, syncs = [], [], []
    launches = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = ev["ts"] * 1e-6, ev.get("dur", 0) * 1e-6
        if cat == "user_annotation":
            if name == trace.PREFIX + "window":
                window = (ts, ts + dur)
            elif name.startswith(PREFIX):
                spans.append((ts, ts + dur, name[len(PREFIX):]))
        elif cat in trace.LAUNCH_CATS:
            if "correlation" in ev.get("args", {}):
                launches[ev["args"]["correlation"]] = ts
            if name in SYNC_CALLS:
                syncs.append(ts)
        elif cat in trace.DEVICE_CATS:
            device.append((ts, ts + dur,
                           ev.get("args", {}).get("correlation")))
    if window is None:
        raise RuntimeError("the traced window's range is missing")
    return window, sorted(spans), launches, device, syncs


def _open_at(t, spans):
    """The spans open at ``t``, innermost (latest start) last."""
    return [sp for sp in spans if sp[0] <= t <= sp[1]]


def _idle(window, device):
    """The window's stretches in which the device ran nothing."""
    w0, w1 = window
    _, merged = trace._union([(max(s, w0), min(e, w1))
                              for s, e, _ in device if e > w0 and s < w1])
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def read(events) -> dict:
    """The spans' readings of a chrome trace's events (times in s):

    ``count``: {span: times opened in the window}; ``self_device_s``:
    {span: device time launched while it was the innermost}; ``idle_s``:
    the window's idle time; ``idle_within_s`` and ``self_idle_s``: {span:
    idle time while it was open / the innermost}; ``idle_outside_s``: idle
    time with no span open, and ``idle_outside_where_s`` the part of it
    before the first span, between spans and after the last; ``syncs``:
    {span: blocking runtime calls made while it was open}; ``gaps``: the
    ten longest idle gaps, [label, seconds], each labelled by the
    innermost span open at its midpoint and the host ops running there."""
    window, all_spans, launches, device, syncs = _events(events)
    w0, w1 = window
    spans = [sp for sp in all_spans if sp[1] > w0 and sp[0] < w1]
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    count = Counter(n for _, _, n in spans)

    self_device_s = defaultdict(float)
    for s, e, corr in device:
        t = launches.get(corr)
        open_ = [] if t is None else _open_at(t, spans)
        if open_:
            self_device_s[open_[-1][2]] += e - s

    # cut every idle stretch at the spans' edges, so each piece has one
    # set of open spans
    cuts = sorted({w0, w1} | {x for s, e, _ in spans for x in (s, e)
                              if w0 < x < w1})
    idle_within_s, self_idle_s = defaultdict(float), defaultdict(float)
    first = min((sp[0] for sp in spans), default=w1)
    last = max((sp[1] for sp in spans), default=w0)
    outside = {"before": 0.0, "between": 0.0, "after": 0.0}
    idle_s = 0.0
    gaps = []
    for g0, g1 in _idle(window, device):
        idle_s += g1 - g0
        pieces = [g0] + [c for c in cuts if g0 < c < g1] + [g1]
        for a, b in zip(pieces, pieces[1:]):
            open_ = _open_at(0.5 * (a + b), spans)
            for sp in open_:
                idle_within_s[sp[2]] += b - a
            if open_:
                self_idle_s[open_[-1][2]] += b - a
            else:
                where = ("before" if b <= first else
                         "after" if a >= last else "between")
                outside[where] += b - a
        gaps.append((g1 - g0, g0))

    ops = [(ev["ts"] * 1e-6, (ev["ts"] + ev.get("dur", 0)) * 1e-6,
            ev.get("name", "")) for ev in events
           if ev.get("ph") == "X" and ev.get("cat") == "cpu_op"]
    labelled = []
    for length, g0 in sorted(gaps, reverse=True)[:10]:
        mid = g0 + 0.5 * length
        open_ = _open_at(mid, spans)
        label = open_[-1][2] if open_ else OUTSIDE
        on = sorted((oe - os_, n) for os_, oe, n in ops if os_ <= mid <= oe)
        if on:  # the outermost host op, and the innermost if another
            label += " > " + on[-1][1]
            if len(on) > 1:
                label += " > " + on[0][1]
        labelled.append([label[:160], length])

    sync_count = Counter()
    for t in syncs:
        if w0 <= t <= w1:
            for sp in _open_at(t, spans):
                sync_count[sp[2]] += 1
    return {"count": dict(count), "self_device_s": dict(self_device_s),
            "idle_s": idle_s,
            "idle_within_s": dict(idle_within_s),
            "self_idle_s": dict(self_idle_s),
            "idle_outside_s": sum(outside.values()),
            "idle_outside_where_s": outside,
            "syncs": dict(sync_count), "gaps": labelled}


def attributed_share(reading) -> float | None:
    """The share of the window's idle time inside some span, in %."""
    if reading["idle_s"] <= 0:
        return None
    return 100.0 * (1.0 - reading["idle_outside_s"] / reading["idle_s"])


def infer_metrics(reading, images: int) -> dict:
    """The evaluation's span metrics: each model stage's self device ms an
    image (``<stage>_span_ms.infer``); the idle ms a batch while the batch
    is fetched, enqueued, and brought to the host and collected; the
    blocking runtime calls a batch made inside the forward. A batch is an
    ``eval.forward`` span; a quantity with nothing to read is left out."""
    batches = reading["count"].get("eval.forward", 0)
    out = {}
    if images:
        for stage in STAGES:
            if stage in reading["count"]:
                out[f"{stage}_span_ms.infer"] = (
                    1e3 * reading["self_device_s"].get(stage, 0.0) / images)
    if batches:
        within = reading["idle_within_s"]
        out["fetch_idle_ms.infer"] = 1e3 * within.get("eval.fetch", 0.0) \
            / batches
        out["launch_idle_ms.infer"] = 1e3 * within.get(
            "eval.forward", 0.0) / batches
        out["drain_idle_ms.infer"] = 1e3 * (
            within.get("eval.to_host", 0.0)
            + within.get("eval.collect", 0.0)) / batches
        out["forward_syncs.infer"] = reading["syncs"].get(
            "eval.forward", 0) / batches
    return out
