"""Where the card's bfloat16 parts from the CPU's at full R-101 width, the
instruments behind ``chip_smoke.py`` phase 19 (b). Run on a machine with
the card; each subcommand prints one JSON line a row, and a last line.

    python3 fewshotobjectdetection_imporove_via_text_feature_torch/tools/bf16_card_vs_cpu.py \\
        convs

The backbone of phase 19 (b) (seeded, the conv3s drawn as there) on its
512x864 image in bf16 on the card and on the CPU: each convolution's
output in the chained forward (its largest gap over its largest value,
and the share of elements that differ), then each of a sample of
convolutions replayed on the card from the CPU's own input, against the
CPU's output and a float64 reference in units of the bf16 spacing, under
cuDNN's default and deterministic algorithms and cuBLAS with and without
reduced-precision bf16 reductions.

    ... heads [--std 0.5 0.25]

Phase 19 (b) at each spread of the drawn RPN and box deltas (its
BF16_HEAD_STD), with every rule-1 row and both detection comparisons (on
T''s proposals, held; on each arm's own, reported).

    ... sampling

The training step of phase 19 (b) before its proposals were handed over:
seeded heads, batch 2 at 512x853 in the 512x864 bucket, each arm on its
own proposals (the card in bf16 and in exact float32, the CPU in both):
each arm's losses and its proposals' widths and heights, the RPN
outputs' gaps, the share of equal proposals, and each image's foreground
ROIs that one arm samples and the other does not.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SETTINGS = {
    "default": (False, True),
    "no_reduced_reduction": (False, False),
    "deterministic": (True, True),
    "both": (True, False),
}


def smoke():
    """``chip_smoke.py`` of this checkout, as a module."""
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location(
        "smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ulps(x, ref):
    """|x - ref| in units of the bf16 spacing at |ref| (float64)."""
    import torch

    spacing = 2.0 ** (torch.floor(torch.log2(
        torch.clamp(ref.abs(), min=1e-30))) - 7)
    return (x.double() - ref).abs() / spacing


def convs(sm):
    import torch
    import torch.nn.functional as F
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        DefaultPredictor,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.predictor import (
        preprocess_single_image,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.models.backbone import (
        Conv2d,
    )

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    opts = sm._bf16_full_opts()
    image = sm._synthetic_images(19, 1, *sm.BF16_FULL_HW)[0]
    state = DefaultPredictor(sm._cfg("float32", opts), device="cpu",
                             seed=0).model.state_dict()
    gen = torch.Generator().manual_seed(19)
    for name in list(state):
        if name.endswith("conv3.weight"):
            w = state[name]
            state[name] = torch.randn(w.shape, generator=gen) * (
                0.2 / w[0].numel() ** 0.5)

    def run(dev):
        cfg = sm._cfg("bfloat16", opts)
        model = DefaultPredictor(cfg, device=dev, state_dict=state).model
        ins, outs, hooks = {}, {}, []
        for name, mod in model.backbone.named_modules():
            if isinstance(mod, Conv2d):
                hooks.append(mod.register_forward_pre_hook(
                    lambda m, a, name=name: ins.__setitem__(
                        name, a[0].detach().cpu())))
                hooks.append(mod.register_forward_hook(
                    lambda m, a, o, name=name: outs.__setitem__(
                        name, o.detach().cpu())))
        with torch.no_grad():
            res4, _ = model.compute_features(
                preprocess_single_image(cfg, image).to(dev))
        for h in hooks:
            h.remove()
        return model, ins, outs, res4.float().cpu()

    cpu, ins, tout, t4 = run("cpu")
    _, _, cout, c4 = run("cuda")
    for name, t in tout.items():
        t, c = t.float(), cout[name].float()
        print(json.dumps(dict(
            kind="chained", name=name,
            gap=float((c - t).abs().max() / t.abs().max()),
            differ=float((c != t).float().mean()))), flush=True)
    names = list(tout)
    modules = dict(cpu.backbone.named_modules())
    for i, name in enumerate(names):
        if i >= 6 and i % 8:
            continue
        mod, x = modules[name], ins[name]
        w = mod.weight.detach().to(torch.bfloat16)
        args = (mod.stride, mod.padding, mod.dilation, mod.groups)
        with torch.no_grad():
            t = F.conv2d(x, w, None, *args)
            ref = F.conv2d(x.double(), w.double(), None, *args)
            row = dict(kind="replay", name=name, weight=list(w.shape),
                       cpu_ulps_mean=float(ulps(t, ref).mean()))
            for key, (det, reduced) in SETTINGS.items():
                torch.backends.cudnn.deterministic = det
                torch.backends.cuda.matmul \
                    .allow_bf16_reduced_precision_reduction = reduced
                c = F.conv2d(x.cuda(), w.cuda(), None, *args).cpu()
                row[key] = dict(ulps_mean=float(ulps(c, ref).mean()),
                                differ=float((c != t).float().mean()))
        print(json.dumps(row), flush=True)
    torch.backends.cudnn.deterministic = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    print(json.dumps(dict(
        res4_gap=float((c4 - t4).abs().max() / t4.abs().max()),
        res4_differ=float((c4 != t4).float().mean()))), flush=True)


def heads(sm, stds):
    sm.phase_build()
    for std in stds:
        sm.BF16_HEAD_STD = std
        rule = sm._Rule4()
        _, _, full = sm._bf16_full_width(rule)
        for row in rule.rows:
            print(json.dumps(dict(row, head_std=std), default=str),
                  flush=True)
        print(json.dumps(dict(head_std=std, failed=rule.failed,
                              calibration=full["calibration"])),
              flush=True)


def sampling(sm):
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        DefaultPredictor,
        step_generators,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.trainer import (
        exact_float32,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        build_model,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.box_ops import (
        pairwise_iou,
    )

    sm.phase_build()
    opts = ["INPUT.MIN_SIZE_TEST", "512", "INPUT.MAX_SIZE_TEST", "864",
            "MODEL.BACKBONE.FREEZE_AT", "0"]
    state = DefaultPredictor(sm._cfg("float32", opts), device="cpu",
                             seed=0).model.state_dict()
    gen = torch.Generator().manual_seed(19)
    for name in list(state):
        if name.endswith("conv3.weight"):
            w = state[name]
            state[name] = torch.randn(w.shape, generator=gen) * (
                0.2 / w[0].numel() ** 0.5)
    (images, gt), = sm.train_batches(19, 1, 2, h=512, w=853,
                                     bucket=(512, 864))
    rec = {}
    for arm, dev, dt in (("T'", "cpu", "bfloat16"), ("C", "cuda", "bfloat16"),
                         ("R'", "cpu", "float32"),
                         ("C32", "cuda", "float32")):
        model = build_model(sm._cfg(dt, opts))
        model.load_state_dict(state)
        model.to(dev).train()
        heads = {}
        hook = model.proposal_generator.rpn_head.register_forward_hook(
            lambda m, i, o: heads.update(logits=o[0].detach().float().cpu(),
                                         deltas=o[1].detach().float().cpu()))
        records, restore = sm._recording_sampler()
        ctx = exact_float32() if arm == "C32" else torch.no_grad()
        try:
            with ctx, torch.no_grad():
                losses = model.forward_train(images.to(dev), gt.to(dev),
                                             *step_generators(0, 0, "cpu"))
        finally:
            restore()
            hook.remove()
        p, pv, smp, sv = (t.cpu() for t in records[0])
        rec[arm] = dict(p=p, pv=pv, s=smp, sv=sv, **heads)
        wh = p[pv][:, 2:] - p[pv][:, :2]
        q = torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0])
        print(json.dumps(dict(
            arm=arm, fg=float(losses["metric/roi_num_fg_samples"]),
            loss_box_reg=float(losses["loss_box_reg"]),
            loss_cls=float(losses["loss_cls"]),
            proposal_width_quantiles=torch.quantile(wh[:, 0], q).tolist(),
            proposal_height_quantiles=torch.quantile(wh[:, 1], q).tolist())),
              flush=True)

    def foreground(r, i):
        boxes = r["s"][i][r["sv"][i]]
        iou = pairwise_iou(gt.boxes[i][gt.valid[i]], boxes).max(0).values
        return boxes[iou >= 0.5], iou[iou >= 0.5]

    for a, b in (("C", "T'"), ("T'", "R'"), ("C32", "R'"), ("C", "C32")):
        ra, rb = rec[a], rec[b]
        row = dict(pair=f"{a} vs {b}")
        for k in ("logits", "deltas"):
            d = (ra[k] - rb[k]).abs()
            row[k] = dict(max_gap=float(d.max()),
                          max_ref=float(rb[k].abs().max()),
                          differ=float((d > 0).float().mean()))
        row["proposals_equal"] = float(
            ((ra["p"] == rb["p"]).all(-1) & (ra["pv"] == rb["pv"]))
            .float().mean())
        for i in range(len(gt.boxes)):
            fa, ia = foreground(ra, i)
            fb, ib = foreground(rb, i)
            row[f"image{i}"] = dict(
                fg=[len(fa), len(fb)],
                only_first=[(x.tolist(), float(u)) for x, u in zip(fa, ia)
                            if not (fb == x).all(-1).any()],
                only_second=[(x.tolist(), float(u)) for x, u in zip(fb, ib)
                             if not (fa == x).all(-1).any()])
        print(json.dumps(row), flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("convs", "heads", "sampling"):
        raise SystemExit(__doc__)
    sm = smoke()
    if argv[0] == "convs":
        convs(sm)
    elif argv[0] == "sampling":
        sampling(sm)
    else:
        stds = [0.5]
        if "--std" in argv:
            stds = [float(x) for x in argv[argv.index("--std") + 1:]]
        heads(sm, stds)


if __name__ == "__main__":
    main()
