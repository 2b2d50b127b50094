"""Named spans of the port's stages, on ``torch.profiler``'s clock.

``with span("rpn"): ...`` opens ``record_function("fsod.rpn")`` while a
profiler is collecting, so the span's start and end sit in the profiler's
trace beside the kernels, copies and runtime calls made inside it, on the
same clock: a reader of the trace puts every device interval and every
idle gap of the device under the spans open when it was launched or left
idle. Spans nest by time on their thread; a stage's self time is its span
less its children's, which the reader computes.

While no profiler collects, ``span`` returns one shared no-op context: one
check of the profiler's state, no allocation and no dispatcher call, and
no profiler op in a ``torch.export`` program. Nothing switches the spans
on but a profiler: the trainer's TPU.PROFILE_START_STEP window, a
``torch.profiler.profile`` around ``inference_on_dataset``, or a
benchmark's trace.

The spans (``fsod.`` + name):
    eval.fetch, eval.forward, eval.to_host, eval.pcb, eval.collect
        each batch of ``evaluation/evaluator.py`` ``inference_on_dataset``
    normalize, backbone, branch, rpn, roi_heads, detections
        the stages of ``models/meta_arch.py``'s forward (``detections`` in
        inference only)
    train.fetch, train.forward, train.backward, train.optimizer,
    train.log, train.checkpoint
        each step of ``engine/trainer.py``
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "fsod."
_OFF = contextlib.nullcontext()


def span(name: str):
    """The context of the span ``fsod.<name>``: a profiler range while a
    profiler collects, else the shared no-op."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
