"""The reductions that the per-layer readers in ``metrics/`` share. Each
returns None where its run has nothing to read (no trace, no launch of the
kernel), and the harness then leaves the metric out of the line."""

from __future__ import annotations

from . import trace


def idle_share(ctx):
    """1 - busy / window of the traced run, in %."""
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(ctx):
    """The least time the window's FLOPs need at the card's peaks (each
    precision at its own) over the window's time, in %."""
    if not ctx.get("window_s"):
        return None
    return 100.0 * ctx["ideal_s"] / ctx["window_s"]


def range_ms(ctx, name: str, per: str):
    """Device milliseconds of the kernels launched inside the host range
    ``name``, per image or per step (``per``: the traced count's key)."""
    t = ctx.get("trace")
    if not t or name not in t["by_range"] or not ctx.get(per):
        return None
    return 1e3 * t["by_range"][name] / ctx[per]


def roofline(ctx, op: str, kernel_fragment: str):
    """The least time the operator's calls need (``work.py``, summed over
    the calls of the untraced pass over the traced inputs) over its
    kernels' device time in the trace, in %."""
    t, w = ctx.get("trace"), ctx.get("work")
    if not t or not w or op not in w or not w[op]["calls"]:
        return None
    device_s = trace.kernel_seconds(t, kernel_fragment)
    if device_s <= 0:
        return None
    return 100.0 * w[op]["least_s"] / device_s
