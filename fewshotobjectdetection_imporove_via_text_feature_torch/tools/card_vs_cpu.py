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
runs free from the CPU's state after them.

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
# set by this tool, not taken from the script's command lines
_OWN_KEYS = ("MODEL.WEIGHTS", "OUTPUT_DIR", "TEST.EXPECTED_RESULTS")


def _script() -> str:
    with open(GATE_SCRIPT) as f:
        return f.read()


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
    knobs = dict(re.findall(r"^(\w+)=\$\{\1:-([^}]*)\}", text, re.M))
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

    def __init__(self, cfg, device):
        from ..engine import Trainer
        from ..engine.trainer import make_train_step
        from ..solver import build_gradient_clipper

        self.device = device
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
        images, gt = batch[0].to(self.device), batch[1].to(self.device)
        return {k: float(v) for k, v in self.step(images, gt, it).items()}


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


def first_step(cfg_card, cfg_cpu, batch):
    """Step 0 on both devices from one checkpoint, same batch and draws:
    the losses' largest relative gap, and the gradients' largest
    difference over their largest magnitude (the steppers come back to
    step on)."""
    card = _Stepper(cfg_card, cfg_card.MODEL.DEVICE)
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
             card_device="cuda", out_dir="card_vs_cpu_out", resync=0):
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
    plumbing check: every gap is 0)."""
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
        card, cpu, first = first_step(cfg_card, cfg_cpu, next(loader))
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
    return out


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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("steps", "evaluate", "decoders"):
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
        if name == "steps":
            s.add_argument("--steps", type=int, default=50)
            s.add_argument("--seed", type=int, default=5)
            s.add_argument("--resync", type=int, default=0)
        else:
            s.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    datasets = os.path.abspath(a.datasets)
    if a.cmd == "steps":
        res = lockstep(a.weights, datasets, a.steps, a.arm, a.seed, a.opts,
                       out_dir=a.save, resync=a.resync)
        for r in res["steps"]:
            print(f"step {r['step']}: total loss card "
                  f"{r['card']['total_loss']:.8f} cpu "
                  f"{r['cpu']['total_loss']:.8f} rel {r['total_rel']:.3e}"
                  + (f" groups {r['groups']}" if "groups" in r else ""))
    elif a.cmd == "evaluate":
        res = evaluate(a.weights, datasets, a.device, a.save, a.opts, a.arm)
    else:
        res = decoder_gaps(datasets)
    line = json.dumps(res)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
