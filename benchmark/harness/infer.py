"""The evaluation driver: the program's ``inference_on_dataset`` over
resident, page-locked batches, cycled for the window, as the program's
command line evaluates after a fine-tune (no PCB).

Traffic keys: ``batch``; ``images``, a list of {"width", "height",
"count"} (the pool, the same sizes for every seed); ``sampled_batches``,
how many of the pool's batches the check compares; ``trace_batches``, how
many batches the traced run profiles; ``limits``, the check's limits.
"""

from __future__ import annotations

import shutil
import sys
import tempfile
import time

import torch

from . import capture, checks_infer, images, port
from .core import (Phases, judge, passes, peak_bytes, seconds_since_start,
                   sub_seed, sync)


def make_pool(traffic: dict, cfg, seed: int, device):
    """The pool's batches: [(host batch, bucket)], grouped by bucket as the
    program's test loader groups them, in an order drawn from the seed."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    short, max_size = cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST
    buckets = tuple(tuple(b) for b in cfg.TPU.IMAGE_BUCKETS)
    groups = {}
    next_id = 0
    for spec in traffic["images"]:
        h, w, n = spec["height"], spec["width"], spec["count"]
        img, _, _, _ = images.draw_images(
            n, h, w, cfg.MODEL.ROI_HEADS.NUM_CLASSES, gen, device)
        nh, nw = images.resize_shortest_edge(h, w, short, max_size)
        bucket = images.pick_bucket(nh, nw, buckets)
        x, _ = images.resize_into(img, torch.zeros(n, 0, 4, device=device),
                                  nh, nw, bucket)
        g = groups.setdefault(bucket, {"x": [], "hw": [], "orig": [],
                                       "ids": []})
        g["x"].append(x)
        g["hw"] += [(nh, nw)] * n
        g["orig"] += [(h, w)] * n
        g["ids"] += list(range(next_id, next_id + n))
        next_id += n
    batch = traffic["batch"]
    pool = []
    for bucket, g in groups.items():
        x = torch.cat(g["x"])
        perm = torch.randperm(x.shape[0], generator=gen, device=device)
        hw = torch.tensor(g["hw"], dtype=torch.int32)[perm.cpu()]
        orig = torch.tensor(g["orig"], dtype=torch.int32)[perm.cpu()]
        ids = [g["ids"][i] for i in perm.tolist()]
        x = x[perm]
        if x.shape[0] % batch:
            raise ValueError(f"bucket {bucket}: {x.shape[0]} images do not "
                             f"fill batches of {batch}")
        for s in range(0, x.shape[0], batch):
            hb = images.host_batch(
                x[s:s + batch], hw[s:s + batch], orig[s:s + batch],
                torch.zeros(batch, 0, 4),
                torch.zeros(batch, 0, dtype=torch.int32),
                torch.zeros(batch, 0, dtype=torch.bool), cfg.TPU.MAX_GT,
                ids[s:s + batch])
            pool.append((hb, bucket))
    order = torch.randperm(len(pool), generator=gen, device=device).tolist()
    return [pool[i] for i in order]


def sampled(pool, count: int, seed: int):
    """The pool positions the check compares: one batch of each bucket in
    turn, drawn from the seed, ``count`` in all."""
    g = torch.Generator().manual_seed(sub_seed(seed, 3))
    by_bucket = {}
    for i, (_, bucket) in enumerate(pool):
        by_bucket.setdefault(bucket, []).append(i)
    picks = []
    lists = [v for _, v in sorted(by_bucket.items())]
    while len(picks) < min(count, len(pool)):
        for v in lists:
            left = [i for i in v if i not in picks]
            if left and len(picks) < count:
                picks.append(left[int(torch.randint(len(left), (1,),
                                                    generator=g))])
    return picks


class WindowLoader:
    """Cycles the pool until ``seconds`` have passed since ``start()`` and
    every sampled batch has come once; arms the stage capture for each
    sampled batch the first time it comes."""

    def __init__(self, pool, seconds, cap=None, sample=()):
        self.pool, self.seconds, self.cap = pool, seconds, cap
        self.sample = set(sample)
        self.yielded = 0
        self.per_bucket = {}
        self.t0 = None

    def start(self):
        self.t0 = time.perf_counter()

    def __iter__(self):
        k = 0
        while (time.perf_counter() - self.t0 < self.seconds
               or k < max(self.sample, default=-1) + 1):
            pos = k % len(self.pool)
            if self.cap is not None:
                first = pos in self.sample and pos not in self.cap.store
                self.cap.armed = pos if first else None
            batch, bucket = self.pool[pos]
            n = batch[0].image.shape[0]
            self.yielded += n
            self.per_bucket[bucket] = self.per_bucket.get(bucket, 0) + n
            yield batch
            k += 1
        if self.cap is not None:
            self.cap.armed = None


def trace_inference(model, pool, count: int, device) -> dict:
    """The traced readings over ``count`` batches of the pool: the
    profiler's trace with the layer ranges, then the ``fsod::`` operators'
    work on the same batches, untraced."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation \
        .evaluator import inference_on_dataset

    from . import trace

    batches = [pool[i % len(pool)][0] for i in range(count)]
    ranges = trace.Ranges()
    ranges.hook(model.backbone, pre=[("begin", "backbone")],
                post=[("end", "backbone")])
    ranges.hook(model.proposal_generator.rpn_head, pre=[("begin", "rpn")])
    ranges.hook(model.roi_heads, pre=[("end", "rpn"),
                                      ("begin", "roi_heads")])
    forward = model.forward_inference

    def ranged(*a, **k):  # the ROI heads' range ends with the detections
        try:
            return forward(*a, **k)
        finally:
            ranges.end_all()

    model.forward_inference = ranged
    try:
        reading = trace.profile(
            lambda: inference_on_dataset(model, batches, None), device)
    finally:
        del model.forward_inference
        ranges.remove()
    with trace.OpRecorder() as rec:
        inference_on_dataset(model, batches, None)
    return {"trace": reading, "work": rec.work,
            "images": sum(b[0].image.shape[0] for b in batches)}


def run(args, cell: dict, device) -> dict:
    """Set-up, warm-up, the window, the optional trace, and the check."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation \
        .evaluator import inference_on_dataset

    from . import work

    config, traffic = cell["config"], cell["traffic"]
    phases = Phases(device)
    out_dir = tempfile.mkdtemp(prefix="bench_")
    cfg = port.build_cfg(config, out_dir)
    model = port.build_model(cfg, device)
    phases.mark("model")
    state = port.seeded_state(model, config, sub_seed(args.seed, 1), device)
    port.load_state(model, state)
    model.eval()
    phases.mark("weights")
    pool = make_pool(traffic, cfg, args.seed, device)
    phases.mark("images")

    # warm-up: every bucket shape of the pool, twice, through the same call
    first = {}
    for i, (_, bucket) in enumerate(pool):
        first.setdefault(bucket, i)
    inference_on_dataset(model, [pool[i][0] for i in first.values()] * 2,
                         None)
    phases.mark("warm-up")
    setup_s = seconds_since_start()
    phases.report(setup_s)

    sample = sampled(pool, traffic["sampled_batches"], args.seed)
    cap = capture.StageCapture(model)
    keep_ids = [iid for i in sample for iid in pool[i][0][2]["image_ids"]]
    rec = capture.make_recorder(keep_ids)
    loader = WindowLoader(pool, args.seconds, cap, sample)
    loader.start()
    inference_on_dataset(model, loader, rec)
    sync(device)
    window_s = time.perf_counter() - loader.t0
    cap.remove()
    done = rec.images
    rate = done / window_s
    ideal = sum(n * work.ideal_seconds(work.inference_flops(cfg, b),
                                       config["compute_dtype"])
                for b, n in loader.per_bucket.items())
    ctx = {"rate": rate, "window_s": window_s,
           "ideal_s": ideal}
    if args.trace:
        ctx.update(trace_inference(model, pool, traffic["trace_batches"],
                                   device))
    peak = peak_bytes(device)

    caps = []
    for i in sample:
        (ib, _, meta), _ = pool[i]
        c = cap.store.get(i)
        if c is None:
            continue
        empty = (torch.zeros(0, 4), torch.zeros(0), torch.zeros(0))
        c.update(image=ib.image.to(device), hw=ib.hw, orig_hw=ib.orig_hw,
                 det=[rec.kept.get(iid, empty)
                      for iid in meta["image_ids"]])
        caps.append(c)
    del model, cap
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = checks_infer.detector_for(config, cfg, state)
    s = checks_infer.settings(cfg)
    values = {n: 0.0 for n in checks_infer.NAMES}
    stage_s = {}
    for c in caps:
        got = checks_infer.compare(c, ref, s, seconds=stage_s)
        values = {n: max(values[n], got[n]) for n in values}
    checks = judge(values, traffic["limits"])
    checks["batches_checked"] = {"value": len(caps), "limit": len(sample),
                                 "rule": "value >= limit"}
    checks["images_lost"] = {"value": loader.yielded - done, "limit": 0,
                             "rule": "value <= limit"}
    check_s = time.perf_counter() - t
    print("check stages: " + ", ".join(f"{k} {v:.2f} s"
                                       for k, v in stage_s.items()),
          file=sys.stderr)
    shutil.rmtree(out_dir, ignore_errors=True)
    return {
        "correct": all(passes(c) for c in checks.values()),
        "attempted": loader.yielded, "failed": loader.yielded - done,
        "e2e": {traffic["rate_metric"]: rate, "setup_s": setup_s},
        "window_s": window_s, "setup_s": setup_s, "peak": peak,
        "checks": checks, "check_s": check_s, "ctx": ctx,
    }

