"""The training driver: the program's ``Trainer``, built as the command line
builds it for a fine-tune, stepping resident, page-locked batches through
``Trainer.train_step`` (``make_train_step``: forward, backward, SGD) and
the program's ``device_batches`` copies, as ``Trainer.train`` does, but
with no checkpoint and no log written in the window.

Traffic keys: ``batch``; ``pool`` ({"width", "height", "count"}: the
images the batches draw from); ``batches`` ({"orientation",
"short_sides", "count"}: how many batches of each bucket group, each image
resized to a short side drawn from ``short_sides``); ``checked_steps``
(the first steps, which the reference follows); ``trace_steps``;
``limits``.
"""

from __future__ import annotations

import math
import shutil
import sys
import tempfile
import time

import torch

from . import checks_train, images, port
from .core import (Phases, judge, passes, peak_bytes, seconds_since_start,
                   sub_seed, sync)
from .weights import draw_state


def make_batches(traffic: dict, cfg, seed: int, device):
    """[(host batch, canvas)]: every batch's images drawn from the pool's
    images of its orientation, each resized to a short side drawn from
    its group's sides and padded to the group's bucket; the batches in an
    order drawn from the seed."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    buckets = tuple(tuple(b) for b in cfg.TPU.IMAGE_BUCKETS)
    max_size = cfg.INPUT.MAX_SIZE_TRAIN
    pool = {"landscape": [], "portrait": []}
    for spec in traffic["pool"]:
        h, w, n = spec["height"], spec["width"], spec["count"]
        img, boxes, cls, valid = images.draw_images(n, h, w, classes, gen,
                                                    device)
        side = "landscape" if w >= h else "portrait"
        pool[side] += [(img[i:i + 1], boxes[i:i + 1], cls[i:i + 1],
                        valid[i:i + 1]) for i in range(n)]
    order = {k: torch.randperm(len(v), generator=gen, device=device).tolist()
             for k, v in pool.items()}
    used = {k: 0 for k in pool}
    batch = traffic["batch"]
    out = []
    for group in traffic["batches"]:
        side = group["orientation"]
        shorts = group["short_sides"]
        for _ in range(group["count"]):
            picks = []
            for _ in range(batch):
                picks.append(pool[side][order[side][used[side] %
                                                    len(order[side])]])
                used[side] += 1
            draws = torch.randint(len(shorts), (batch,), generator=gen,
                                  device=device).tolist()
            sizes = []
            for (img, _, _, _), d in zip(picks, draws):
                h, w = img.shape[1:3]
                sizes.append(images.resize_shortest_edge(h, w, shorts[d],
                                                         max_size))
            canvas = max((images.pick_bucket(nh, nw, buckets)
                          for nh, nw in sizes), key=lambda b: b[0] * b[1])
            xs, bs = [], []
            for (img, bx, _, _), (nh, nw) in zip(picks, sizes):
                x, b = images.resize_into(img, bx, nh, nw, canvas)
                xs.append(x)
                bs.append(b)
            hb = images.host_batch(
                torch.cat(xs), torch.tensor(sizes, dtype=torch.int32),
                torch.tensor([p[0].shape[1:3] for p in picks],
                             dtype=torch.int32),
                torch.cat(bs), torch.cat([p[2] for p in picks]),
                torch.cat([p[3] for p in picks]), cfg.TPU.MAX_GT,
                range(len(out) * batch, (len(out) + 1) * batch))
            out.append((hb, canvas))
    perm = torch.randperm(len(out), generator=gen, device=device).tolist()
    return [out[i] for i in perm]


class RoiCapture:
    """While ``armed`` holds a key, copies the step's RPN head outputs
    (logits, deltas and the map's size, a hook on the RPN head) and its
    sampled ROIs (boxes, their classes, validity, a pre-hook on the ROI
    heads)."""

    def __init__(self, model):
        self.armed = None
        self.store = {}
        self.rpn = {}
        self.handles = [
            model.proposal_generator.rpn_head.register_forward_hook(
                self._rpn),
            model.roi_heads.register_forward_pre_hook(
                self._hook, with_kwargs=True)]

    def _rpn(self, mod, args, out):
        if self.armed is not None:
            self.rpn[self.armed] = (out[0].detach().float().clone(),
                                    out[1].detach().float().clone(),
                                    tuple(args[0].shape[2:]))

    def _hook(self, mod, args, kwargs):
        if self.armed is not None:
            self.store[self.armed] = (
                args[1].detach().clone(),
                kwargs["gt_classes"].detach().clone(),
                kwargs["valid"].detach().clone())

    def remove(self):
        for h in self.handles:
            h.remove()


def _feed(batches, order, device):
    from fewshotobjectdetection_imporove_via_text_feature_torch.data.loader \
        import device_batches

    return device_batches((batches[i][0] for i in order), device)


def trace_training(trainer, batches, start: int, it: int, count: int,
                   device) -> dict:
    """The traced readings over ``count`` steps (the profiler with the
    layer ranges), then the ``fsod::`` operators' work on the same batches
    in as many more steps, untraced."""
    from . import trace

    model = trainer.model
    ranges = trace.Ranges()
    ranges.hook(model.backbone, pre=[("begin", "backbone")],
                post=[("end", "backbone")])
    ranges.hook(model.roi_heads.attention, pre=[("begin", "attention")],
                post=[("end", "attention")])
    order = [(start + k) % len(batches) for k in range(count)]

    def steps(first):
        for k, (images_, gt, meta) in enumerate(_feed(batches, order,
                                                      device)):
            trainer.train_step(images_, gt, first + k, meta)

    try:
        reading = trace.profile(lambda: steps(it), device)
    finally:
        ranges.remove()
    with trace.OpRecorder() as rec:
        steps(it + count)
        sync(device)
    return {"trace": reading, "work": rec.work, "steps": count,
            "images": count * trainer.cfg.SOLVER.IMS_PER_BATCH}


def run(args, cell: dict, device, control=None) -> dict:
    """Set-up (the checked steps and a step on every other canvas), the
    window, the optional trace, and the check. ``control`` (a ``quant``
    function): the reference in that precision takes the program's place
    in the check, on the program's own sampled ROIs."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine \
        import Trainer

    from . import work

    config, traffic = cell["config"], cell["traffic"]
    phases = Phases(device)
    out_dir = tempfile.mkdtemp(prefix="bench_")
    prog_seed = sub_seed(args.seed, 4) % (2 ** 31)
    cfg = port.build_cfg(config, out_dir, ["SEED", str(prog_seed)])
    shapes = port.state_shapes(port.build_model(cfg, "meta"))
    rules = [(p, r) for p, r in config["weights"]]
    state = draw_state(shapes, rules, sub_seed(args.seed, 1), device)
    bank_shape = tuple(config["class_embed"]["shape"])
    bank = draw_state({"class_embed": bank_shape}, rules,
                      sub_seed(args.seed, 5), device)["class_embed"]
    phases.mark("weights")
    trainer = Trainer(cfg, data=[], device=device, state_dict=state)
    model = trainer.model
    with torch.no_grad():
        model.roi_heads.attention.class_embed.copy_(bank)
    phases.mark("trainer")
    batches = make_batches(traffic, cfg, args.seed, device)
    phases.mark("images")
    names = dict(model.named_parameters())
    trainable = checks_train.trainable_names(cfg, model)

    checked = traffic["checked_steps"]
    batch = cfg.SOLVER.IMS_PER_BATCH
    if traffic["batch"] != batch:
        raise ValueError(f"the traffic's batch {traffic['batch']} is not "
                         f"the configuration's IMS_PER_BATCH {batch}")
    cap = RoiCapture(model)
    feed = _feed(batches, range(checked), device)
    prog_losses, buf0, it = [], None, 0
    for k, (images_, gt, meta) in enumerate(feed):
        cap.armed = k
        losses = trainer.train_step(images_, gt, it, meta)
        prog_losses.append({n: float(v) for n, v in losses.items()})
        it += 1
        if k == 0:
            st = trainer.optimizer.state
            # a parameter the optimizer keeps no buffer for has moved by 0
            buf0 = {n: st[names[n]].get("momentum_buffer",
                                        torch.zeros_like(names[n]))
                    .detach().clone() for n in trainable}
    cap.armed = None
    cap.remove()
    phases.mark("checked steps")
    params_after = {n: names[n].detach().clone() for n in trainable}
    # a step on every canvas the checked steps did not use
    seen = {batches[k][1] for k in range(checked)}
    for k, (_, canvas) in enumerate(batches):
        if canvas not in seen:
            seen.add(canvas)
            images_, gt, meta = next(iter(_feed(batches, [k], device)))
            trainer.train_step(images_, gt, it, meta)
            it += 1
    phases.mark("warm-up")
    setup_s = seconds_since_start()
    phases.report(setup_s)
    print(f"float32 matmul precision {torch.get_float32_matmul_precision()}"
          f", matmul TF32 {torch.backends.cuda.matmul.allow_tf32}, cuDNN "
          f"TF32 {torch.backends.cudnn.allow_tf32}", file=sys.stderr)

    per_canvas = {}
    steps, pos = 0, checked
    t0 = time.perf_counter()
    window = _cycle_feed(batches, pos, device)
    last = prog_losses[-1]
    while time.perf_counter() - t0 < args.seconds:
        images_, gt, meta, canvas = next(window)
        last = trainer.train_step(images_, gt, it, meta)
        per_canvas[canvas] = per_canvas.get(canvas, 0) + 1
        it += 1
        steps += 1
    sync(device)
    window_s = time.perf_counter() - t0
    window.close()
    # a step object whose weights went to NaN or inf steps on at the same
    # pace: the window's last loss shows it
    final_loss = sum(float(v) for n, v in last.items()
                     if n.startswith("loss_"))
    rate = steps * batch / window_s
    ideal = sum(n * work.ideal_seconds(
        work.train_flops(cfg, c, batch), config["compute_dtype"])
        for c, n in per_canvas.items())
    ctx = {"rate": rate, "window_s": window_s,
           "ideal_s": ideal}
    if args.trace:
        ctx.update(trace_training(trainer, batches, pos + steps, it,
                                  traffic["trace_steps"], device))
    peak = peak_bytes(device)
    del trainer, model, names, feed
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    checked_batches = [batches[k][0] for k in range(checked)]
    rois = [cap.store.get(k) for k in range(checked)]
    # every image of a checked step reached the ROI heads
    seen = min((r[0].shape[0] if r is not None else 0) for r in rois)
    values = {n: float("inf") for n in checks_train.NAMES}
    if seen == batch:
        ref_out = checks_train.follow(cfg, state, bank, checked_batches,
                                      rois, trainable, prog_seed, device)
        totals = [sum(v for n, v in ls.items() if n.startswith("loss_"))
                  for ls in prog_losses]
        grad0 = checks_train.optimizer_gradient(cfg, trainable, state, buf0)
        if control is not None:
            totals, grad0, params_after = checks_train.follow(
                cfg, state, bank, checked_batches, rois, trainable,
                prog_seed, device, quant=control)
        values = checks_train.compare(cfg, state, trainable, ref_out,
                                      totals, grad0, params_after)
        values.update(checks_train.sampling(
            cfg, checked_batches, rois, [cap.rpn.get(k)
                                         for k in range(checked)]))
        print("check detail: " + checks_train.describe(
            cfg, state, trainable, ref_out, totals, grad0, params_after),
            file=sys.stderr)
    checks = judge(values, traffic["limits"])
    checks["images_stepped"] = {"value": seen, "limit": batch,
                                "rule": "value >= limit"}
    checks["final_loss_finite"] = {"value": int(math.isfinite(final_loss)),
                                   "limit": 1, "rule": "value >= limit"}
    print(f"the window's last loss {final_loss!r}", file=sys.stderr)
    check_s = time.perf_counter() - t
    print("check readings: " + ", ".join(f"{k} {v!r}" for k, v in
                                         values.items()), file=sys.stderr)
    shutil.rmtree(out_dir, ignore_errors=True)
    return {
        "correct": all(passes(c) for c in checks.values()),
        "attempted": steps * batch, "failed": 0,
        "e2e": {traffic["rate_metric"]: rate, "setup_s": setup_s},
        "window_s": window_s, "setup_s": setup_s, "peak": peak,
        "checks": checks, "check_s": check_s, "ctx": ctx,
    }


def _cycle_feed(batches, start: int, device):
    """(images, gt, meta, canvas) on the device, cycling from ``start``."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.data.loader \
        import device_batches

    def host():
        k = start
        while True:
            hb, canvas = batches[k % len(batches)]
            canvases.append(canvas)
            yield hb
            k += 1

    canvases = []
    for n, (images_, gt, meta) in enumerate(device_batches(host(), device)):
        yield images_, gt, meta, canvases[n]
