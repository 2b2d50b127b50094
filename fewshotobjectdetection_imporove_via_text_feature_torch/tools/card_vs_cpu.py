"""The held-out gate's legs on the card against the CPU: the instruments
that find where the two devices part, and what ``chip_smoke.py`` phase 18
runs. The settings are those of ``tools/check_generalization.sh``: its
TINY_OPTS and each leg's own options are read from the script. Each
subcommand prints one JSON line last.

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.card_vs_cpu \
        steps --datasets DIR [--weights SURGERED.pth] [--steps 50] \
        [--arm clean|sabotaged|base] [--seed 5] [--save DIR] [--resync K]

N training steps of one leg (``clean``: the ft leg from a surgered
checkpoint; ``sabotaged``: the ab leg; ``base``: the base leg from the
seed's initial weights) on the card and on the CPU in lockstep, on the
same decoded batches (the train loader's, decoded once on the host), the
sampling and dropout drawn on the host (``make_train_step(draw_device=
"cpu")``; a float32 card step runs with TF32 off and deterministic
algorithms): each step's losses, the first step whose sample counts
differ, and each parameter group's distance between the two devices
against its movement. Both devices' final weights are saved under
``--save``. ``--resync K`` hands the card the CPU's parameters and
momentum before each of the first K steps (all of them when K is the step
count), so that each such step's gap is that step's alone, and the card
runs free from the CPU's state after them; then each resynced step's
update is compared by parameter group (gap, norm ratio, cosine, the tensor
with the largest gap), and the first step whose gap in a group exceeds
1e-4 of its update while the sample counts are equal is named.
``--card-device cpu --card-threads N`` runs the CPU against itself at
another thread count: the gaps of the CPU's own float32 summation order.

    ... convs --datasets DIR --weights CKPT --arm sabotaged --step K

Step K on the CPU's trajectory and on the card from the CPU's state before
it: by convolution, where the card's activations and output gradients part
from the CPU's, and each convolution recomputed from the CPU's recorded
tensors in float32 on the card and on the CPU, each against float64.

    ... sweep --device cuda|cpu --seeds 5-28 --out RUNS.jsonl \
        [--cached-bases DIR] [--jobs N]

The port's ``check_generalization.sh`` at each ``GEN_SEED``, legs base, ft
and ab (with ``--cached-bases``, ft and ab from the seed's surgered base:
``DIR/s<seed>.ckpt``/``.pth`` or a gate directory's
``s<seed>/base1/model_reset_surgery.*``, a JAX package ``.ckpt`` read as
``MODEL.WEIGHTS`` reads it), ``--jobs`` seeds at a time: one record a seed
(base strict AP and AP50, the clean and sabotaged arms' held-out strict
bAP and bAP50, d = clean - sabotaged strict bAP, each leg's wall and exit
code) appended to RUNS.jsonl.

    ... collect --logs DIR --out RUNS.jsonl

The same records from gate directories already written, by either
package's gate script (their logs share the ``copypaste:`` layout).

    ... compare A.jsonl B.jsonl [--paired]

B against A on d and on base strict AP: means, SDs, 95% percentile
intervals of 10 000 bootstrap resamples over seeds (numpy's
``default_rng(0)``), the difference of the means and the SD ratio with
theirs, the pass share at margin 1, the Mann-Whitney U p-value, and with
``--paired`` the seed-paired differences of d.

    ... evaluate --datasets DIR --weights CKPT [--device cpu] [--arm base]

The held-out evaluation of a checkpoint on a device: the gfsod test set,
or with ``--arm base`` the base leg's.

    ... decoders --datasets DIR

The pixels of the two decode paths of ``data/mapper.py`` (the native core's
and PIL's) on the gate's images at each training and test scale: max and
mean absolute difference.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re
import shlex
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG = "fewshotobjectdetection_imporove_via_text_feature_torch"
GATE_SCRIPT = os.path.join(ROOT, PKG, "tools", "check_generalization.sh")
TEMPLATE = os.path.join(ROOT, "configs", "voc",
                        "defrcn_gfsod_r101_novelx_10shot_seedx.yaml")
# tools/create_config.py's datasets for --shot 10 --seed 0 --split 1
GFSOD_DATASETS = ["DATASETS.TRAIN", "('voc_2007_trainval_all1_10shot_seed0',)",
                  "DATASETS.TEST", "('voc_2007_test_all1',)"]
# each arm's leg, by the banner the gate script echoes before it
LEGS = {"clean": "gfsod 10-shot fine-tune", "sabotaged": "contract A/B",
        "base": "base training"}
# the parameter groups whose movement is compared, by name prefix
GROUPS = (("stem", ("backbone.stem.",)),
          ("res2-res4", ("backbone.res2.", "backbone.res3.",
                         "backbone.res4.")),
          ("res5", ("roi_heads.res5.",)),
          ("rpn", ("proposal_generator.",)),
          ("box_predictor", ("roi_heads.box_predictor.",)))
# a group's update gap, over its update, that part 4 of a resync reports
UPDATE_TOL = 1e-4
# set by this tool, not taken from the script's command lines
_OWN_KEYS = ("MODEL.WEIGHTS", "OUTPUT_DIR", "TEST.EXPECTED_RESULTS")


def _script() -> str:
    with open(GATE_SCRIPT) as f:
        return f.read()


def _knobs(text):
    """The script's ``NAME=${NAME:-default}`` knobs and their defaults."""
    return dict(re.findall(r"^(\w+)=\$\{\1:-([^}]*)\}", text, re.M))


def gate_tiny_opts(device: str, seed: int):
    """The gate script's TINY_OPTS as a KEY VALUE list."""
    text = re.search(r'TINY_OPTS="(.*?)"', _script(), re.S).group(1)
    text = text.replace("${DEVICE}", device).replace("${GEN_SEED:-5}",
                                                     str(seed))
    return text.split()


def leg_opts(arm: str):
    """(config file, KEY VALUE list): the gate script's CLI command of
    ``arm``'s leg (``LEGS``) at the script's default knobs, less TINY_OPTS
    and the keys this tool sets itself."""
    if arm not in LEGS:
        raise ValueError(f"arm {arm!r}: one of {', '.join(LEGS)}")
    text = _script()
    knobs = _knobs(text)
    block = text.split(f'echo "=== {LEGS[arm]}', 1)[1]
    cmd = block[block.index("--config-file"):block.index("2>&1")]
    cmd = re.sub(r"\$\(\((\w+)\*(\d+)/(\d+)\)\)",
                 lambda m: str(int(knobs[m[1]]) * int(m[2]) // int(m[3])),
                 cmd.replace("\\\n", " "))
    cmd = re.sub(r"\$\{(ITERS_\w+)\}", lambda m: knobs[m[1]], cmd)
    words = [w for w in shlex.split(cmd) if w != "${TINY_OPTS}"]
    opts = words[words.index("--opts") + 1:]
    pairs = [(k, v) for k, v in zip(opts[0::2], opts[1::2])
             if k not in _OWN_KEYS]
    return words[1], [x for kv in pairs for x in kv]


def gate_cfg(weights: str, arm: str = "clean", seed: int = 5,
             device: str = "cuda", out_dir: str = "", opts=()):
    """The config of ``arm``'s leg: the ft (clean) or ab (sabotaged) leg
    from the surgered ``weights``, as ``tools/create_config.py`` makes it
    for the script; the base leg from ``weights`` ("" for the seed's
    initial weights)."""
    from ..config import get_cfg

    config, own = leg_opts(arm)
    cfg = get_cfg()
    if arm == "base":
        cfg.merge_from_file(os.path.join(ROOT, config))
    else:
        cfg.merge_from_file(TEMPLATE)
        own = [*GFSOD_DATASETS, *own]
    cfg.merge_from_list([*own, "MODEL.WEIGHTS", weights, "OUTPUT_DIR",
                         out_dir, *gate_tiny_opts(device, seed), *opts])
    return cfg


def host_batches(cfg, n: int):
    """The train loader's first ``n`` batches, decoded once, in host
    memory: both devices step on the same pixels."""
    from ..data.loader import build_detection_train_loader

    loader = build_detection_train_loader(cfg, seed=cfg.SEED)
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


class _Stepper:
    """One device's training: the Trainer's model, optimizer and schedule
    from the config, stepped by ``make_train_step`` with host draws on
    either device."""

    def __init__(self, cfg, device, threads=0):
        from ..engine import Trainer
        from ..engine.trainer import make_train_step
        from ..solver import build_gradient_clipper

        self.device, self.threads = device, threads
        tr = Trainer(cfg, data=[], device=device)
        self.model, self.optimizer = tr.model, tr.optimizer
        self.step = make_train_step(
            tr.model, tr.optimizer, tr.scheduler,
            build_gradient_clipper(cfg), tr.seed, draw_device="cpu")
        self.start = self.params()

    def params(self):
        return {n: p.detach().to("cpu", copy=True)
                for n, p in self.model.named_parameters()}

    def follow(self, other):
        """Take ``other``'s parameters and momentum (a copy: on one device
        the optimizer would otherwise share ``other``'s buffers)."""
        self.model.load_state_dict(other.model.state_dict())
        self.optimizer.load_state_dict(
            copy.deepcopy(other.optimizer.state_dict()))

    def grads(self):
        return {n: p.grad.detach().cpu()
                for n, p in self.model.named_parameters()
                if p.grad is not None}

    def __call__(self, batch, it):
        import torch

        images, gt = batch[0].to(self.device), batch[1].to(self.device)
        held = torch.get_num_threads()
        if self.threads:  # this stepper's own intra-op threads
            torch.set_num_threads(self.threads)
        try:
            return {k: float(v)
                    for k, v in self.step(images, gt, it).items()}
        finally:
            torch.set_num_threads(held)


def _group_of(name):
    return next((g for g, prefixes in GROUPS
                 if name.startswith(prefixes)), None)


def _norm(tensors):
    return float(np.sqrt(sum(float((t.double() ** 2).sum())
                             for t in tensors))) if tensors else 0.0


def group_gaps(card, cpu, start):
    """Per group: the card's and the CPU's distance (L2 over the group)
    and the CPU's movement from ``start``."""
    out = {}
    for g, _ in GROUPS:
        names = [n for n in start if _group_of(n) == g]
        out[g] = {"gap": _norm([card[n] - cpu[n] for n in names]),
                  "moved": _norm([cpu[n] - start[n] for n in names])}
    return out


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-12)


def first_step(cfg_card, cfg_cpu, batch, card_threads=0):
    """Step 0 on both devices from one checkpoint, same batch and draws:
    the losses' largest relative gap, and the gradients' largest
    difference over their largest magnitude (the steppers come back to
    step on)."""
    card = _Stepper(cfg_card, cfg_card.MODEL.DEVICE, card_threads)
    cpu = _Stepper(cfg_cpu, "cpu")
    lc, lh = card(batch, 0), cpu(batch, 0)
    gc, gh = card.grads(), cpu.grads()
    if gc.keys() != gh.keys():
        raise RuntimeError(f"parameters with a gradient differ: "
                           f"{sorted(gc.keys() ^ gh.keys())[:8]}")
    top = max(float(t.abs().max()) for t in gh.values())
    worst = max(gh, key=lambda n: float((gc[n] - gh[n]).abs().max()))
    return card, cpu, {
        "losses_card": lc, "losses_cpu": lh,
        "loss_rel": max(rel(lc[k], lh[k]) for k in lh
                        if not k.startswith("metric/")),
        "grad_err": float((gc[worst] - gh[worst]).abs().max()) / top,
        "grad_worst": worst, "grad_max": top}


def lockstep(weights, datasets, steps, arm="clean", seed=5, opts=(),
             card_device="cuda", out_dir="card_vs_cpu_out", resync=0,
             card_threads=0):
    """``steps`` training steps of ``arm``'s leg on the card and the CPU
    in lockstep (module docstring), the batches taken from one loader as
    the steps go. Returns the per-step record, the steps whose sample
    counts differ and the two final weights' paths (``card.pth``,
    ``cpu.pth`` in ``out_dir``). Before each of steps 1 to ``resync`` - 1
    the card takes the CPU's parameters and momentum, so every such step's
    gap is that one step's along the CPU's trajectory (``update_rel``: the
    distance of the two updates over the CPU's), where without it float
    noise compounds from step to step; after them the card runs free from
    the CPU's state. ``card_device`` "cpu" runs the CPU against itself (a
    plumbing check: every gap is 0); with ``card_threads`` the stand-in
    steps with that many intra-op threads, so the gaps are those of the
    CPU's float32 summation order alone."""
    import torch

    from ..data import register_all
    from ..data.loader import build_detection_train_loader

    register_all(datasets)
    cfg_card = gate_cfg(weights, arm, seed, card_device,
                        os.path.join(out_dir, "card"), opts)
    cfg_cpu = gate_cfg(weights, arm, seed, "cpu",
                       os.path.join(out_dir, "cpu"), opts)
    loader = build_detection_train_loader(cfg_cpu, seed=cfg_cpu.SEED)
    try:
        card, cpu, first = first_step(cfg_card, cfg_cpu, next(loader),
                                      card_threads)
        rows = [{"step": 0, "card": first["losses_card"],
                 "cpu": first["losses_cpu"]}]
        for it in range(1, steps):
            batch = next(loader)
            synced = it < resync
            if synced:
                card.follow(cpu)
                before = cpu.params()
            rows.append({"step": it, "card": card(batch, it),
                         "cpu": cpu(batch, it)})
            if synced:
                pc, ph = card.params(), cpu.params()
                rows[-1]["update_rel"] = (
                    _norm([pc[n] - ph[n] for n in ph])
                    / max(_norm([ph[n] - before[n] for n in ph]), 1e-30))
                rows[-1]["update_groups"] = update_groups(pc, ph, before)
            if it in (1, 2, 5, 10, 20) or it == steps - 1 or it % 10 == 0:
                rows[-1]["groups"] = group_gaps(card.params(), cpu.params(),
                                                cpu.start)
    finally:
        loader.close()
    paths = {}
    for name, stepper in (("card", card), ("cpu", cpu)):
        paths[name] = os.path.join(out_dir, f"{name}.pth")
        torch.save({k: v.cpu() for k, v in
                    stepper.model.state_dict().items()}, paths[name])
    del card, cpu
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    for r in rows:
        r["total_rel"] = rel(r["card"]["total_loss"], r["cpu"]["total_loss"])
    counts = [k for k in rows[0]["cpu"] if k.endswith(("_samples",
                                                       "_anchors"))]
    parted = [r["step"] for r in rows
              if any(r["card"][k] != r["cpu"][k] for k in counts)]
    out = {"first_step": first, "steps": rows,
           "max_total_rel": max(r["total_rel"] for r in rows),
           "counts_differ_at": parted, "weights": paths}
    if resync > 1:
        out["max_update_rel"] = max(r["update_rel"] for r in rows
                                    if "update_rel" in r)
        out.update(resync_summary(rows, set(parted)))
    return out


def update_groups(card, cpu, before):
    """Per parameter group, one step's update on the card against the
    CPU's from the same ``before``: the gap over the CPU's update
    (``gap_rel``), the norm ratio (card over CPU), the cosine, and the
    tensor with the largest gap (``worst``, its gap over its own update).
    None for a group that did not move on the CPU."""
    out = {}
    for g, _ in GROUPS:
        names = [n for n in before if _group_of(n) == g]
        dc = [card[n].double() - before[n].double() for n in names]
        dh = [cpu[n].double() - before[n].double() for n in names]
        nh, nc = _norm(dh), _norm(dc)
        if nh == 0.0:
            out[g] = None
            continue
        dot = sum(float((a * b).sum()) for a, b in zip(dc, dh))
        gaps = [_norm([a - b]) for a, b in zip(dc, dh)]
        worst = int(np.argmax(gaps))
        out[g] = {"gap_rel": _norm([a - b for a, b in zip(dc, dh)]) / nh,
                  "norm_ratio": nc / nh,
                  "cos": dot / (nc * nh) if nc else 0.0,
                  "worst": names[worst],
                  "worst_gap_rel": gaps[worst]
                  / max(_norm([dh[worst]]), 1e-30)}
    return out


def resync_summary(rows, parted, tol=UPDATE_TOL):
    """Over the resynced steps whose sample counts are equal on both
    devices: the first at which a group's update gap exceeds ``tol`` of
    its update (``first_group_over``: step, group, gap; None if there is
    none), and per group the gap's median, p90 and max, the median norm
    ratio and cosine and the share of steps where the card's update is
    the longer; the share of them where the card's loss is above the
    CPU's."""
    synced = [r for r in rows
              if "update_groups" in r and r["step"] not in parted]
    first = None
    for r in synced:
        over = [(g, u["gap_rel"]) for g, u in r["update_groups"].items()
                if u is not None and u["gap_rel"] > tol]
        if over:
            g, gap = max(over, key=lambda t: t[1])
            u = r["update_groups"][g]
            first = {"step": r["step"], "group": g, "gap_rel": gap,
                     "worst": u.get("worst"),
                     "worst_gap_rel": u.get("worst_gap_rel")}
            break
    groups = {}
    for g, _ in GROUPS:
        us = [r["update_groups"][g] for r in synced
              if r["update_groups"].get(g) is not None]
        if not us:
            continue
        gap = np.array([u["gap_rel"] for u in us])
        ratio = np.array([u["norm_ratio"] for u in us])
        groups[g] = {"steps": len(us), "gap_median": float(np.median(gap)),
                     "gap_p90": float(np.percentile(gap, 90)),
                     "gap_max": float(gap.max()),
                     "norm_ratio_median": float(np.median(ratio)),
                     "card_longer_share": float(np.mean(ratio > 1.0)),
                     "cos_median": float(np.median(
                         [u["cos"] for u in us]))}
    above = [r["card"]["total_loss"] > r["cpu"]["total_loss"]
             for r in synced]
    return {"first_group_over": first, "update_tol": tol,
            "synced_equal_counts": len(synced), "group_updates": groups,
            "card_loss_above_share": float(np.mean(above)) if above
            else None}


def _conv_tape(names):
    """A ``TorchFunctionMode`` that records every ``F.conv2d`` call: the
    weight's parameter name, its input, weight, bias and options, and (by
    a hook on its output) the gradient that reaches its output."""
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    class Tape(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func is F.conv2d:
                x, w, *rest = args
                bias = rest[0] if rest else kwargs.get("bias")
                rec = {"name": names.get(w.data_ptr(), "?"),
                       "x": x.detach().clone(), "w": w.detach().clone(),
                       "b": None if bias is None else bias.detach().clone(),
                       "opts": tuple(rest[1:]), "kwopts": {
                           k: v for k, v in kwargs.items() if k != "bias"}}
                if out.requires_grad:
                    out.register_hook(lambda g, rec=rec: rec.__setitem__(
                        "gy", g.detach().clone()))
                self.calls.append(rec)
            return out

    return Tape()


def _conv_replay(rec, device, dtype):
    """One recorded convolution's output and its input and weight
    gradients, recomputed on ``device`` in ``dtype`` (a float32 CUDA
    replay under ``exact_float32``), as float64 on the host."""
    import contextlib

    import torch
    import torch.nn.functional as F

    from ..engine.trainer import exact_float32

    ctx = exact_float32() if torch.device(device).type == "cuda" else \
        contextlib.nullcontext()
    with ctx:
        x = rec["x"].to(device, dtype, copy=True).requires_grad_()
        w = rec["w"].to(device, dtype, copy=True).requires_grad_()
        b = None if rec["b"] is None else rec["b"].to(device, dtype)
        y = F.conv2d(x, w, b, *rec["opts"], **rec["kwopts"])
        y.backward(rec["gy"].to(device, dtype))
    return [t.detach().double().cpu() for t in (y, x.grad, w.grad)]


def conv_errors(weights, datasets, step, arm="sabotaged", seed=5, opts=(),
                card_device="cuda", out_dir="card_vs_cpu_out"):
    """Training step ``step`` of ``arm``'s leg, on the CPU's trajectory
    (the host draws of ``lockstep``), run again on the card from the CPU's
    state before it, every ``F.conv2d`` of both recorded: by layer in call
    order, the card's input (``x_gap``) and output gradient (``gy_gap``)
    against the CPU's, relative to the CPU's; and each convolution's
    output and input and weight gradients recomputed from the CPU's
    recorded tensors in float32 on the card and on the CPU, each against
    the float64 result (``||a - ref|| / ||ref||``). Also the step's losses
    on both and the parameters whose gradients differ most."""
    import torch

    from ..data import register_all
    from ..data.loader import build_detection_train_loader

    register_all(datasets)
    cfg = gate_cfg(weights, arm, seed, "cpu", out_dir, opts)
    cpu = _Stepper(cfg, "cpu")
    loader = build_detection_train_loader(cfg, seed=cfg.SEED)
    try:
        for it in range(step):
            cpu(next(loader), it)
        batch = next(loader)
    finally:
        loader.close()
    card = _Stepper(gate_cfg(weights, arm, seed, card_device, out_dir, opts),
                    card_device)
    card.follow(cpu)
    tapes, losses = {}, {}
    for key, stepper in (("cpu", cpu), ("card", card)):
        names = {p.data_ptr(): n
                 for n, p in stepper.model.named_parameters()}
        tapes[key] = _conv_tape(names)
        with tapes[key]:
            losses[key] = stepper(batch, step)
    gc, gh = card.grads(), cpu.grads()
    grad_gaps = sorted(((n, _norm([gc[n] - gh[n]])
                         / max(_norm([gh[n]]), 1e-30)) for n in gh),
                       key=lambda t: -t[1])
    rows = []
    for rec, crec in zip(tapes["cpu"].calls, tapes["card"].calls):
        if "gy" not in rec:
            continue
        ref = _conv_replay(rec, "cpu", torch.float64)
        row = {"name": rec["name"], "x": list(rec["x"].shape),
               "w": list(rec["w"].shape)}
        for q in ("x", "gy"):
            a, b = crec[q].double().cpu(), rec[q].double()
            row[f"{q}_gap"] = _norm([a - b]) / max(_norm([b]), 1e-300)
        for dev, key in ((card_device, "card"), ("cpu", "cpu")):
            got = _conv_replay(rec, dev, torch.float32)
            row[key] = {q: _norm([g - r]) / max(_norm([r]), 1e-300)
                        for q, g, r in zip(("y", "dx", "dw"), got, ref)}
        rows.append(row)
    return {"step": step, "arm": arm, "seed": seed, "losses": losses,
            "convs": rows, "grad_gaps": grad_gaps[:8]}


def card_repeat(weights, datasets, steps, arm="clean", seed=5,
                device="cuda", out_dir="card_vs_cpu_out"):
    """The Trainer's float32 step on ``device`` twice from one checkpoint
    over the same ``steps`` batches: whether every loss and, at the end,
    every parameter of the second run is bitwise the first's."""
    from ..data import register_all
    from ..engine import Trainer

    register_all(datasets)
    cfg = gate_cfg(weights, arm, seed, device, out_dir)
    batches = host_batches(cfg, steps)
    runs = []
    for _ in range(2):
        tr = Trainer(cfg, data=[], device=device)
        losses = []
        for it, b in enumerate(batches):
            images, gt = b[0].to(tr.device), b[1].to(tr.device)
            losses.append({k: v.cpu() for k, v in
                           tr.train_step(images, gt, it).items()})
        runs.append((losses, {n: p.detach().cpu() for n, p in
                              tr.model.named_parameters()}))
    (l0, p0), (l1, p1) = runs
    return {"steps": steps,
            "losses_equal": all(torch_equal(a, b) for a, b in zip(l0, l1)),
            "params_equal": torch_equal(p0, p1)}


def torch_equal(a: dict, b: dict) -> bool:
    import torch

    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def evaluate(weights, datasets, device, out_dir, opts=(), arm="clean"):
    """The held-out evaluation of ``weights`` on ``device`` in ``arm``'s
    leg (the gfsod test set, or the base leg's): the evaluator's bbox
    metrics."""
    from .. import cli

    if arm == "base":
        config = os.path.join(ROOT, leg_opts(arm)[0])
        test = "voc_2007_test_base1"
    else:
        config, test = TEMPLATE, "voc_2007_test_all1"
    argv = ["--config-file", config, "--eval-only", "--opts",
            *(GFSOD_DATASETS if arm != "base" else []), "MODEL.WEIGHTS",
            weights, "OUTPUT_DIR", out_dir, "TEST.PCB_ENABLE", "False",
            *gate_tiny_opts(device, 5), *opts]
    os.environ["FSODTF_DATASETS"] = datasets
    return cli.main(argv)[test]["bbox"]


def decoder_gaps(datasets, sizes=(224, 256, 288), max_size=384):
    """PIL against the native core on every JPEG of the gate's VOC2007 and
    VOC2012 trees at each short edge: max and mean absolute difference of
    the resized uint8 pixels, as the mapper makes them."""
    import glob

    from PIL import Image

    from ..data import native_io
    from ..data.mapper import resize_shortest_edge_size

    if not native_io.available():
        raise RuntimeError("the native data-IO core is unavailable here")
    files = sorted(glob.glob(os.path.join(datasets, "VOC20*", "JPEGImages",
                                          "*.jpg")))
    out = {"images": len(files)}
    for short in sizes:
        mx, total, count = 0.0, 0.0, 0
        for f in files:
            img = Image.open(f).convert("RGB")
            w0, h0 = img.size
            h, w = resize_shortest_edge_size(h0, w0, short, max_size)
            pil = np.asarray(img.resize((w, h), Image.BILINEAR), np.float64)
            canvas, _, _ = native_io.load_image(f, short, max_size, (h, w),
                                                bgr=False)
            nat = np.clip(canvas + 0.5, 0, 255).astype(np.uint8)
            d = np.abs(pil - nat)
            mx, total, count = max(mx, float(d.max())), total + d.sum(), \
                count + d.size
        out[str(short)] = {"max_abs": mx, "mean_abs": total / count}
    return out


# ------------------------------------------------ the gate's statistic --
# each leg's log in a gate directory, as the gate script names it
LEG_LOGS = {"base": "base1.log", "ft": "10shot_seed0.log",
            "ab": "ab_sab.log"}
_STAMP = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3}) ", re.M)


def _text(path):
    with open(path, errors="replace") as f:
        return f.read()


def copypaste_row(text):
    """The last ``copypaste:`` row of a leg's log text as floats (the
    layout AP,AP50,AP75[,bAP,bAP50,bAP75,nAP,nAP50,nAP75], read as the
    gate script's ``metric`` reads it), or None when the log has none."""
    rows = [ln for ln in text.splitlines()
            if "copypaste:" in ln and "," in ln]
    if not rows:
        return None
    return [float(v) for v in
            rows[-1].split("copypaste:")[-1].strip().split(",")]


def log_wall(text):
    """Seconds from a log's first to its last time stamp (the CLI's
    logger; the interpreter's start before its first line is not in
    it)."""
    import datetime

    stamps = [datetime.datetime.strptime(d, "%Y-%m-%d %H:%M:%S")
              .timestamp() + int(ms) / 1000
              for d, ms in _STAMP.findall(text)]
    return round(stamps[-1] - stamps[0], 3) if stamps else None


def _seed_of(save_dir):
    for leg in ("base1", "10shot_seed0", "ab_sab"):
        cfg = os.path.join(save_dir, leg, "config.yaml")
        if os.path.isfile(cfg):
            m = re.search(r"^SEED: (-?\d+)", _text(cfg), re.M)
            if m:
                return int(m[1])
    m = re.search(r"(\d+)$", os.path.basename(os.path.normpath(save_dir)))
    return int(m[1]) if m else None


def gate_record(save_dir, seed=None):
    """One seed's record from a gate directory of either package's
    ``check_generalization.sh`` (its legs' logs, ``LEG_LOGS``): base
    strict AP and AP50, the clean (ft) and sabotaged (ab) arms' held-out
    strict bAP and bAP50, ``d`` = clean - sabotaged strict bAP, and each
    leg's wall and exit code. A leg's ``rc`` is what its step of the
    script exits with: for base and ft the CLI's TEST.EXPECTED_RESULTS
    check (1 where the log says ``Result verification failed`` or has no
    result), for ab the script's assert ``d >= SAB_MARGIN``; None where
    the leg did not run."""
    margin = float(_knobs(_script())["SAB_MARGIN"])
    rec = {"seed": _seed_of(save_dir) if seed is None else seed,
           "base_ap": None, "base_ap50": None, "clean_bap": None,
           "clean_bap50": None, "sab_bap": None, "sab_bap50": None,
           "d": None, "legs": {}}
    rows = {}
    for leg, name in LEG_LOGS.items():
        path = os.path.join(save_dir, name)
        if not os.path.isfile(path):
            rec["legs"][leg] = {"rc": None, "wall_s": None}
            continue
        text = _text(path)
        rows[leg] = row = copypaste_row(text)
        failed = row is None or "Result verification failed" in text
        rec["legs"][leg] = {"rc": int(failed), "wall_s": log_wall(text)}
    if rows.get("base"):
        rec["base_ap"], rec["base_ap50"] = rows["base"][:2]
    for arm, leg in (("clean", "ft"), ("sab", "ab")):
        if rows.get(leg) and len(rows[leg]) > 4:
            rec[f"{arm}_bap"], rec[f"{arm}_bap50"] = rows[leg][3:5]
    if rec["clean_bap"] is not None and rec["sab_bap"] is not None:
        rec["d"] = rec["clean_bap"] - rec["sab_bap"]
        if rec["legs"]["ab"]["rc"] == 0:
            rec["legs"]["ab"]["rc"] = int(rec["d"] < margin)
    return rec


def collect(logs, out=None):
    """The records (``gate_record``) of every gate directory under
    ``logs`` (a directory that holds a leg's log, at any depth), by
    seed."""
    dirs = sorted({os.path.dirname(os.path.join(d, f))
                   for d, _, files in os.walk(logs) for f in files
                   if f in LEG_LOGS.values()})
    recs = sorted((gate_record(d) for d in dirs),
                  key=lambda r: (r["seed"] is None, r["seed"] or 0))
    if out:
        with open(out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in recs)
    return recs


def parse_seeds(text):
    """``5-28``, ``5,7,9`` or ``5-10,12`` as a list of ints."""
    seeds = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        seeds += range(int(lo), int(hi or lo) + 1)
    return seeds


def cached_base(bases, seed, dest):
    """Seed ``seed``'s surgered base from ``bases`` (``s<seed>.pth`` /
    ``.ckpt``, or a gate directory ``s<seed>/base1/model_reset_surgery``
    ``.pth`` / ``.ckpt``) as a ``.pth`` the port's gate script takes: a
    JAX package ``.ckpt`` is read by ``checkpoint.load_jax_checkpoint``,
    the loader of ``MODEL.WEIGHTS``, and saved as a state dict."""
    import torch

    from ..checkpoint.checkpointer import load_jax_checkpoint

    for stem in (f"s{seed}", os.path.join(f"s{seed}", "base1",
                                          "model_reset_surgery")):
        for ext in (".pth", ".ckpt"):
            path = os.path.join(bases, stem + ext)
            if not os.path.isfile(path):
                continue
            if ext == ".pth":
                return path
            torch.save({"model": load_jax_checkpoint(path)}, dest)
            return dest
    raise FileNotFoundError(f"no surgered base of seed {seed} in {bases}")


def run_gate(seed, device, save_root, bases=None, threads=None):
    """The port's ``check_generalization.sh`` at ``GEN_SEED=seed`` with
    legs base, ft and ab (ft and ab from seed's base in ``bases``), its
    output in ``save_root/s<seed>.out``: the seed's ``gate_record`` with
    the script's exit code and seconds."""
    import subprocess
    import time

    save = os.path.join(save_root, f"s{seed}")
    env = dict(os.environ, DEVICE=device, GEN_SEED=str(seed),
               GEN_LEGS="base,ft,ab")
    env.pop("GEN_SABOTAGE", None)
    env.pop("GEN_CACHED_BASE", None)
    if bases:
        env["GEN_LEGS"] = "ft,ab"
        env["GEN_CACHED_BASE"] = cached_base(
            bases, seed, os.path.join(save_root, f"s{seed}_base.pth"))
    if threads:
        env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = str(threads)
    t0 = time.time()
    with open(save + ".out", "w") as log:
        rc = subprocess.run(["bash", GATE_SCRIPT, save], cwd=ROOT, env=env,
                            stdout=log, stderr=subprocess.STDOUT).returncode
    rec = gate_record(save, seed)
    rec.update(device=device, script_rc=rc,
               seconds=round(time.time() - t0, 3),
               cached_base=env.get("GEN_CACHED_BASE"))
    return rec


def sweep(device, seeds, out, bases=None, jobs=1, save_root=None):
    """``run_gate`` at each seed, ``jobs`` at a time (each child's torch
    threads the cores over ``jobs``), one record a seed appended to
    ``out`` as it ends. A failed leg is a record with its exit code."""
    from concurrent.futures import ThreadPoolExecutor, as_completed

    save_root = os.path.abspath(save_root or os.path.splitext(out)[0])
    os.makedirs(save_root, exist_ok=True)
    threads = max(1, (os.cpu_count() or 1) // jobs)
    recs = []
    with ThreadPoolExecutor(jobs) as pool:
        futs = [pool.submit(run_gate, s, device, save_root, bases, threads)
                for s in seeds]
        for fut in as_completed(futs):
            recs.append(fut.result())
            with open(out, "a") as f:
                f.write(json.dumps(recs[-1]) + "\n")
            print(f"seed {recs[-1]['seed']}: d {recs[-1]['d']} base "
                  f"{recs[-1]['base_ap']} rc {recs[-1]['script_rc']}",
                  flush=True)
    return sorted(recs, key=lambda r: r["seed"])


def read_records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def mann_whitney_p(x, y):
    """Two-sided p-value of the Mann-Whitney U test, the normal
    approximation with the tie and continuity corrections (scipy's
    ``mannwhitneyu`` asymptotic method), in numpy."""
    import math

    x, y = np.asarray(x, float), np.asarray(y, float)
    n1, n2 = len(x), len(y)
    if not n1 or not n2:
        return None
    allv = np.concatenate([x, y])
    _, inv, counts = np.unique(allv, return_inverse=True,
                               return_counts=True)
    # average ranks: the tied values share the mean of their positions
    ranks = (np.cumsum(counts) - (counts - 1) / 2.0)[inv]
    u1 = ranks[:n1].sum() - n1 * (n1 + 1) / 2.0
    n = n1 + n2
    ties = float((counts ** 3 - counts).sum())
    sd = math.sqrt(n1 * n2 / 12.0 * ((n + 1) - ties / (n * (n - 1))))
    if sd == 0:
        return 1.0
    z = (max(u1, n1 * n2 - u1) - n1 * n2 / 2.0 - 0.5) / sd
    return min(1.0, math.erfc(max(z, 0.0) / math.sqrt(2.0)))


def _interval(draws):
    lo, hi = np.percentile(draws, [2.5, 97.5])
    return [float(lo), float(hi)]


def _summary(v, boot):
    return {"n": len(v), "mean": float(np.mean(v)) if len(v) else None,
            "sd": float(np.std(v, ddof=1)) if len(v) > 1 else None,
            "ci": _interval(boot.mean(1)) if len(v) else None}


def compare(a, b, paired=False, margin=1.0, n_boot=10000):
    """Population ``b`` against ``a`` (lists of ``gate_record``s) on the
    gate's statistic ``d`` and on base strict AP ``b``: each side's mean,
    SD and 95% percentile interval, the difference of the means and the
    SD ratio with theirs (``n_boot`` bootstrap resamples over seeds,
    ``numpy.random.default_rng(0)``), the share of seeds with ``d >=
    margin``, the Mann-Whitney U p-value. ``paired``: also the mean of
    the seed-paired differences of ``d`` (b's minus a's) over resampled
    pairs. ``null_held`` says of each interval whether it holds its null
    (0 for a difference, 1 for the ratio)."""
    rng = np.random.default_rng(0)
    out = {"n_seeds": {"A": len(a), "B": len(b)}}
    held = {}
    for key, name in (("d", "d"), ("base_ap", "b")):
        va = np.array([r[key] for r in a if r.get(key) is not None], float)
        vb = np.array([r[key] for r in b if r.get(key) is not None], float)
        ra = va[rng.integers(0, len(va), (n_boot, len(va)))] if len(va) \
            else np.zeros((n_boot, 0))
        rb = vb[rng.integers(0, len(vb), (n_boot, len(vb)))] if len(vb) \
            else np.zeros((n_boot, 0))
        stat = {"A": _summary(va, ra), "B": _summary(vb, rb)}
        if len(va) and len(vb):
            diff = rb.mean(1) - ra.mean(1)
            stat["delta"] = {"mean": float(vb.mean() - va.mean()),
                             "ci": _interval(diff)}
            held[f"delta_{name}"] = bool(
                stat["delta"]["ci"][0] <= 0 <= stat["delta"]["ci"][1])
            stat["mw_p"] = mann_whitney_p(va, vb)
        if name == "b" and len(va) > 1 and len(vb) > 1:
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = rb.std(1, ddof=1) / ra.std(1, ddof=1)
            ratio = ratio[np.isfinite(ratio)]
            stat["sd_ratio"] = {"value": float(vb.std(ddof=1)
                                               / va.std(ddof=1)),
                                "ci": _interval(ratio)}
            held["sd_ratio_b"] = bool(
                stat["sd_ratio"]["ci"][0] <= 1 <= stat["sd_ratio"]["ci"][1])
        if name == "d":
            stat["pass_share"] = {k: float(np.mean(v >= margin))
                                  if len(v) else None
                                  for k, v in (("A", va), ("B", vb))}
        out[name] = stat
    if paired:
        da = {r["seed"]: r["d"] for r in a if r.get("d") is not None}
        pairs = sorted(s for r in b if r.get("d") is not None
                       for s in [r["seed"]] if s in da)
        db = {r["seed"]: r["d"] for r in b}
        f = np.array([db[s] - da[s] for s in pairs], float)
        rf = f[rng.integers(0, len(f), (n_boot, len(f)))] if len(f) \
            else np.zeros((n_boot, 0))
        out["paired_d"] = {"seeds": pairs, **_summary(f, rf)}
        if len(f):
            held["delta_f"] = bool(out["paired_d"]["ci"][0] <= 0
                                   <= out["paired_d"]["ci"][1])
    out["null_held"] = held
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("sweep")
    s.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    s.add_argument("--seeds", default="5-28")
    s.add_argument("--out", required=True)
    s.add_argument("--cached-bases", default=None)
    s.add_argument("--jobs", type=int, default=1)
    s.add_argument("--save-root", default=None)
    s = sub.add_parser("collect")
    s.add_argument("--logs", required=True)
    s.add_argument("--out", default="")
    s = sub.add_parser("compare")
    s.add_argument("a")
    s.add_argument("b")
    s.add_argument("--paired", action="store_true")
    s.add_argument("--out", default="")
    for name in ("steps", "convs", "evaluate", "decoders"):
        s = sub.add_parser(name)
        s.add_argument("--datasets", required=True)
        s.add_argument("--out", default="")
        if name == "decoders":
            continue
        s.add_argument("--weights", required=name == "evaluate",
                       default="")
        s.add_argument("--arm", default="clean", choices=list(LEGS))
        s.add_argument("--save", default="card_vs_cpu_out")
        s.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
        if name == "convs":
            s.add_argument("--step", type=int, default=2)
            s.add_argument("--seed", type=int, default=5)
            s.add_argument("--card-device", default="cuda")
        elif name == "steps":
            s.add_argument("--steps", type=int, default=50)
            s.add_argument("--seed", type=int, default=5)
            s.add_argument("--resync", type=int, default=0)
            s.add_argument("--card-device", default="cuda")
            s.add_argument("--card-threads", type=int, default=0)
        else:
            s.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    if a.cmd in ("sweep", "collect"):
        recs = (sweep(a.device, parse_seeds(a.seeds), a.out,
                      a.cached_bases, a.jobs, a.save_root)
                if a.cmd == "sweep" else collect(a.logs, a.out))
        res = {k: [r[k] for r in recs] for k in ("seed", "d", "base_ap")}
        res["out"] = a.out
    elif a.cmd == "compare":
        res = compare(read_records(a.a), read_records(a.b), a.paired)
    elif a.cmd == "steps":
        datasets = os.path.abspath(a.datasets)
        res = lockstep(a.weights, datasets, a.steps, a.arm, a.seed, a.opts,
                       card_device=a.card_device, out_dir=a.save,
                       resync=a.resync, card_threads=a.card_threads)
        for r in res["steps"]:
            print(f"step {r['step']}: total loss card "
                  f"{r['card']['total_loss']:.8f} cpu "
                  f"{r['cpu']['total_loss']:.8f} rel {r['total_rel']:.3e}"
                  + (f" groups {r['groups']}" if "groups" in r else ""))
    elif a.cmd == "convs":
        res = conv_errors(a.weights, os.path.abspath(a.datasets), a.step,
                          a.arm, a.seed, a.opts, a.card_device, a.save)
        for r in res["convs"]:
            print(f"{r['name']}: x_gap {r['x_gap']:.3e} gy_gap "
                  f"{r['gy_gap']:.3e} card {r['card']} cpu {r['cpu']}")
    elif a.cmd == "evaluate":
        res = evaluate(a.weights, os.path.abspath(a.datasets), a.device,
                       a.save, a.opts, a.arm)
    else:
        res = decoder_gaps(os.path.abspath(a.datasets))
    line = json.dumps(res)
    if a.out and a.cmd not in ("sweep", "collect"):  # theirs: the records
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
