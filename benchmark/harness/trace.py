"""The traced run's readings: ``torch.profiler`` over a few steady batches
or steps, host ranges that the benchmark's own hooks open and close around
the program's modules, and the inputs of every ``fsod::`` operator call,
recorded by a ``TorchDispatchMode`` in a second, untraced pass over the
same inputs.

From the profiler's trace: the device's busy time (the union of the
intervals of kernels, copies and sets, so work on two streams at once
counts once), each kernel's time, each host range's device time (a kernel
belongs to the range open when its launch was made), and the idle gaps,
each named by the host ranges open during it.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "bench:"


class Ranges:
    """``record_function`` ranges that forward hooks open and close:
    ``hook(module, pre=[...], post=[...])`` with actions ("begin" | "end",
    range name), run before and after the module's forward."""

    def __init__(self):
        self.open = {}
        self.handles = []

    def hook(self, module, pre=(), post=()):
        if pre:
            self.handles.append(module.register_forward_pre_hook(
                lambda m, a: self._do(pre)))
        if post:
            self.handles.append(module.register_forward_hook(
                lambda m, a, o: self._do(post)))

    def _do(self, actions):
        for what, name in actions:
            (self.begin if what == "begin" else self.end)(name)

    def begin(self, name):
        rf = torch.autograd.profiler.record_function(PREFIX + name)
        rf.__enter__()
        self.open[name] = rf

    def end(self, name):
        rf = self.open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)

    def end_all(self):
        for name in list(self.open):
            self.end(name)

    def remove(self):
        self.end_all()
        for h in self.handles:
            h.remove()


class OpRecorder(TorchDispatchMode):
    """Counts the work of every call of an ``fsod::`` operator from its
    inputs and output (``work.py``) as the call is made; every other
    operator passes through untouched. ``work``: {operator: {"calls",
    "ops", "bytes"}}."""

    def __init__(self):
        super().__init__()
        self.work = defaultdict(lambda: defaultdict(float))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "fsod":
            from . import work

            name = func.__name__.split(".")[0]
            ops = nbytes = 0.0
            if name == "nms_sorted":
                boxes, valid, _, max_keep = args
                ops = work.IOU_TEST_OPS * work.nms_iou_tests(out, valid,
                                                             max_keep)
                nbytes = work.nms_bytes(boxes, valid)
            elif name == "roi_align":
                feat, boxes, p, scale, _, stride = args
                nbytes = work.roi_align_fwd_bytes(feat, boxes, p, stride,
                                                  scale)
            elif name == "roi_align_backward":
                grad, boxes, shape, p, scale, _, stride = args
                nbytes = work.roi_align_bwd_bytes(grad, boxes, shape, p,
                                                  stride, scale)
            w = self.work[name]
            w["calls"] += 1
            w["ops"] += ops
            w["bytes"] += nbytes
            # float32 IoU tests against the float32 peak outside the
            # tensor cores; each call's least time, summed
            w["least_s"] += work.least_seconds(ops, work.PEAK_F32_FLOPS,
                                               nbytes)
        return out


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def profile(fn, device):
    """Run ``fn()`` under the profiler inside one host range; returns the
    parsed trace (``read_trace``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.autograd.profiler.record_function(PREFIX + "window"):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return read_trace(events)


def read_trace(events):
    """The readings of a chrome trace's events (times in seconds)."""
    window = None
    ranges = []
    launches = {}
    device = []
    cpu_ops = []
    for ev in events:
        cat = ev.get("cat", "")
        if ev.get("ph") != "X":
            continue
        ts, dur = ev["ts"] * 1e-6, ev.get("dur", 0) * 1e-6
        name = ev.get("name", "")
        if cat == "user_annotation" and name.startswith(PREFIX):
            if name == PREFIX + "window":
                window = (ts, ts + dur)
            else:
                ranges.append((ts, ts + dur, name[len(PREFIX):]))
        elif cat in LAUNCH_CATS and "correlation" in ev.get("args", {}):
            launches[ev["args"]["correlation"]] = ts
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, name,
                           ev.get("args", {}).get("correlation")))
        elif cat == "cpu_op":
            cpu_ops.append((ts, ts + dur, name))
    if window is None:
        raise RuntimeError("the traced window's range is missing")
    w0, w1 = window
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    busy, merged = _union([(max(s, w0), min(e, w1)) for s, e, _, _ in device])

    def open_at(t, spans):
        return [n for s, e, n in spans if s <= t <= e]

    by_kernel = defaultdict(float)
    count = defaultdict(int)
    by_range = defaultdict(float)
    for s, e, name, corr in device:
        by_kernel[name] += e - s
        count[name] += 1
        t = launches.get(corr)
        if t is not None:
            for r in open_at(t, ranges):
                by_range[r] += e - s
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    spans = sorted(((edges[i + 1] - edges[i], edges[i])
                    for i in range(0, len(edges) - 1, 2)
                    if edges[i + 1] > edges[i]), reverse=True)[:10]
    gaps = []
    for length, s in spans:
        mid = s + 0.5 * length
        label = "/".join(open_at(mid, ranges)) or \
            "outside the program's modules"
        ops = sorted((oe - os_, n) for os_, oe, n in cpu_ops
                     if os_ <= mid <= oe)
        if ops:  # the outermost host op, and the innermost if another
            label += " > " + ops[-1][1]
            if len(ops) > 1:
                label += " > " + ops[0][1]
        gaps.append((label, length))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": w1 - w0, "busy_s": busy, "by_kernel": dict(by_kernel),
            "count": dict(count), "by_range": dict(by_range),
            "breakdown": {"device_ops": [[n[:160], v] for n, v in top],
                          "idle_gaps": [[n[:160], v] for n, v in gaps[:10]]}}


def kernel_seconds(reading, fragment: str) -> float:
    return sum(v for k, v in reading["by_kernel"].items() if fragment in k)


def summary(ctx) -> str:
    """One line of the traced run's hand-written kernels: each operator's
    calls and least time, and each matching kernel's launches and time."""
    t, w = ctx.get("trace") or {}, ctx.get("work") or {}
    ops = ", ".join(f"{op} {int(v['calls'])} calls least "
                    f"{1e3 * v['least_s']:.4f} ms" for op, v in w.items())
    kernels = ", ".join(f"{k[:80]} x{t['count'][k]} {1e3 * v:.4f} ms"
                        for k, v in t.get("by_kernel", {}).items()
                        if "fsod_" in k)
    return f"traced work: {ops}; kernels: {kernels}"


