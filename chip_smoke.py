#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA card, with its
hand-written CUDA kernels, and check what comes out.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --profile DIR  # also profile one bf16 batch of
                                         # 8; the table goes to DIR

Phases, each of which fails the run on error:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from csrc/ with nvcc, one process per source;
  3. greedy NMS: the kernel against its plain PyTorch version on the card,
     keep masks exactly equal, at both call sites' shapes and beyond;
  4. ROIAlignV2: the kernel against its plain version, float32 (TF32 off)
     and bfloat16, each within its stated tolerance, at the main path's
     launch shape (8 images x 256 ROIs) and at 1000 ROIs on one image;
  5. DefaultPredictor on configs/voc/defrcn_det_r101_base1.yaml at full
     width on seeded random weights: three batch-1 requests and one
     predict_batch of 8 in float32, set-matched against the same port run
     through the plain ops on the card, then timed in bfloat16 (the default
     COMPUTE_DTYPE). The launch counters are set to 0 just before each run
     and read just after; both runs must show every kernel launched, NMS
     twice a forward (RPN proposals and final detections).

Prints one JSON line with every kernel's numbers, then the card's name and
power limit, then as the last line {"ok": true, "device": {...}}. Exits
non-zero, with no result, when CUDA is absent or the package is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "voc", "defrcn_det_r101_base1.yaml")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor f32 FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# float32 ROIAlign: kernel and plain version sum in different orders
ROI_F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bfloat16 ROIAlign: both accumulate in f32 and round once to bf16, so they
# differ by at most one bf16 step (2**-7 relative) where the sums straddle it
ROI_BF16_TOL = dict(rtol=1e-2, atol=1e-2)
# end to end, float32, kernels vs plain ops: a detection matches when a
# detection of the other run has its class, IoU >= 0.9 and a score within
# 1e-3; at least 95% of each run's detections must match, per image
MATCH_IOU, MATCH_SCORE, MATCH_FRACTION = 0.9, 1e-3, 0.95


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


# ----------------------------------------------------------------- phase 2
def phase_build():
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops import (
        cuda_build,
    )

    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    log(f"build: {len(logs)} kernels in {secs:.1f} s")
    return secs


# ----------------------------------------------------------------- phase 3
def _scene_boxes(gen, b, n, img_h=800.0, img_w=1344.0):
    """Score-sorted boxes in clusters (dense overlaps), with ~2% degenerate
    boxes and the last 5% invalid (padding); made on the host from ``gen``."""
    import torch

    ncl = max(1, n // 24)
    centers = torch.rand(b, ncl, 2, generator=gen) * torch.tensor(
        [img_w, img_h])
    which = torch.randint(0, ncl, (b, n), generator=gen)
    c = torch.gather(centers, 1, which[..., None].expand(b, n, 2))
    c = c + torch.randn(b, n, 2, generator=gen) * 12.0
    wh = torch.exp(torch.empty(b, n, 2).uniform_(2.5, 6.0, generator=gen))
    boxes = torch.cat([c - wh / 2, c + wh / 2], dim=-1)
    boxes[..., 0::2] = boxes[..., 0::2].clamp(0, img_w)
    boxes[..., 1::2] = boxes[..., 1::2].clamp(0, img_h)
    degenerate = torch.rand(b, n, generator=gen) < 0.02
    boxes[..., 2] = torch.where(degenerate, boxes[..., 0], boxes[..., 2])
    valid = torch.rand(b, n, generator=gen) < 0.97
    valid[:, int(n * 0.95):] = False
    return boxes.float(), valid


def _nms_pairs_needed(keep, valid, max_keep):
    """IoU tests greedy NMS needs on this data: each box it visits is
    tested against the boxes kept before it (a box is visited until the
    tile boundary where the sweep stops)."""
    import torch

    b, n = keep.shape
    kept_before = torch.cumsum(keep.long(), dim=1) - keep.long()
    if max_keep is None:
        visited = torch.ones_like(keep)
    else:
        tile_start = (torch.arange(n, device=keep.device) // 128) * 128
        at_tile = kept_before.gather(
            1, tile_start.expand(b, n).contiguous())
        visited = at_tile < max_keep
    return int((kept_before * (visited & valid)).sum())


def phase_nms(gen):
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.nms import (
        nms_sorted_plain,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.nms_cuda import (
        nms_sorted_cuda,
    )

    cases = [
        ("rpn", 8, 6000, 0.7, 1000, False),
        ("final", 8, 2048, 0.5, 100, True),
        ("n12288", 2, 12288, 0.7, None, False),
    ]
    results = {}
    for name, b, n, thr, mk, class_offset in cases:
        boxes, valid = _scene_boxes(gen, b, n)
        if class_offset:  # batched_nms_fixed's shift, 15 classes
            cls = torch.randint(0, 15, (b, n), generator=gen).float()
            vb = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
            unit = vb.amax(dim=(1, 2)) + 1.0
            boxes = boxes + (cls * unit[:, None])[..., None]
        boxes, valid = boxes.cuda(), valid.cuda()
        k_cuda = nms_sorted_cuda(boxes, valid, thr, mk)
        k_plain = nms_sorted_plain(boxes, valid, thr, mk)
        torch.cuda.synchronize()
        diff = int((k_cuda != k_plain).sum())
        if diff:
            raise PhaseError(f"nms[{name}]: {diff} keep flags differ")
        ms = time_ms(lambda: nms_sorted_cuda(boxes, valid, thr, mk), 20)
        plain_ms = time_ms(lambda: nms_sorted_plain(boxes, valid, thr, mk), 2)
        pairs = _nms_pairs_needed(k_plain, valid, mk)
        nbytes = b * n * (16 + 1) + b * n
        bound_ops = 12.0 * pairs / F32_FLOPS * 1e3
        bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        results[name] = dict(
            ms=ms, plain_ms=plain_ms, max_abs_err=0.0,
            bound_ms=max(bound_ops, bound_bytes),
            bound_by="operations" if bound_ops >= bound_bytes else "bytes",
            kept=int(k_plain.sum()),
        )
        log(f"nms[{name}] B={b} N={n} iou={thr} max_keep={mk}: masks equal "
            f"({int(k_plain.sum())} kept); kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {results[name]['bound_ms']:.5f} ms")
    return results


# ----------------------------------------------------------------- phase 4
def _roi_boxes(gen, b, r, img_h=800.0, img_w=1344.0):
    """(b, r, 4) ROIs over the 800x1344 bucket, a few with zero width."""
    import torch

    xy = torch.rand(b, r, 2, generator=gen) * torch.tensor([img_w, img_h])
    wh = torch.exp(torch.empty(b, r, 2).uniform_(2.0, 6.5, generator=gen))
    boxes = torch.cat([xy, xy + wh], dim=-1)
    boxes[..., 0::2] = boxes[..., 0::2].clamp(0, img_w)
    boxes[..., 1::2] = boxes[..., 1::2].clamp(0, img_h)
    boxes[:, :7, 2] = boxes[:, :7, 0]  # degenerate widths: output 0
    return boxes.float()


def _roi_ops(boxes, h, w, p, bin_stride, c, sampling):
    """Interpolation operations of ROIAlign on these ROIs: 8 per bilinear
    sample (4 taps, a multiply and an add each) per output value."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align import (
        roi_sample_geometry,
    )

    flat = boxes.reshape(-1, 4)
    geo = roi_sample_geometry(flat, 1 / 16.0, p, sampling, bin_stride,
                              feat_hw=(h, w))
    gy = (geo.wy > 0).sum(dim=1).expand(flat.shape[0])
    gx = (geo.wx > 0).sum(dim=1).expand(flat.shape[0])
    return float((gy * gx).sum()) * geo.p_out ** 2 * c * 8.0


def phase_roi_align(gen):
    """Kernel vs plain version on a 50x84x1024 map (the res4 map of the
    800x1344 bucket): first at the main path's own launch shape (8 images,
    one 256-ROI chunk each, P=7 with bin_stride 2, channels-last features),
    then 1000 ROIs on one image with and without elision, and P=1."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align import (
        roi_align_plain,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align_cuda import (
        roi_align_cuda,
    )

    h, w, c = 50, 84, 1024
    cases = [  # (label, images, ROIs per image, P, bin_stride)
        ("B8_R256_P7_s2", 8, 256, 7, 2),
        ("B1_R1000_P7_s2", 1, 1000, 7, 2),
        ("B1_R1000_P7_s1", 1, 1000, 7, 1),
        ("B1_R1000_P1_s1", 1, 1000, 1, 1),
    ]
    feat32 = torch.randn(8, c, h, w, generator=gen).cuda()
    boxes_of = {b: _roi_boxes(gen, b, r).cuda() for _, b, r, _, _ in cases}
    results = {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for dtype, tol in ((torch.float32, ROI_F32_TOL),
                       (torch.bfloat16, ROI_BF16_TOL)):
        for label, b, r, p, stride in cases:
            # the main path hands the kernel channels-last features
            feat = feat32[:b].to(dtype).contiguous(
                memory_format=torch.channels_last)
            boxes = boxes_of[b]
            args = (feat, boxes, p, 1 / 16.0, 0, stride)
            got = roi_align_cuda(*args)
            ref = roi_align_plain(*args)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            if dtype == torch.float32 and b == 1:
                ref64 = roi_align_plain(feat.double(), *args[1:])
                log(f"  vs float64: kernel "
                    f"{float((got.double() - ref64).abs().max()):.3g}, plain "
                    f"{float((ref.double() - ref64).abs().max()):.3g}")
            key = f"{str(dtype).split('.')[-1]}_{label}"
            if not torch.allclose(got.float(), ref.float(), **tol):
                raise PhaseError(
                    f"roi_align[{key}]: max abs err {err} outside {tol}")
            ms = time_ms(lambda: roi_align_cuda(*args), 10)
            plain_ms = time_ms(lambda: roi_align_plain(*args), 3)
            esize = feat.element_size()
            p_out = len(range(0, p, stride))
            nbytes = feat.numel() * esize + boxes.numel() * 4 \
                + b * r * p_out * p_out * c * esize
            bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ops = _roi_ops(boxes, h, w, p, stride, c, 0) \
                / F32_FLOPS * 1e3
            results[key] = dict(
                ms=ms, plain_ms=plain_ms, max_abs_err=err,
                bound_ms=max(bound_ops, bound_bytes),
                bound_by="operations" if bound_ops >= bound_bytes
                else "bytes",
            )
            log(f"roi_align[{key}] map {b}x{h}x{w}x{c}: max abs err "
                f"{err:.3g} (tol {tol}); kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {results[key]['bound_ms']:.4f} ms "
                f"({results[key]['bound_by']})")
    return results


# ----------------------------------------------------------------- phase 5
def _synthetic_images(seed: int, n: int, h: int = 800, w: int = 1333):
    """BGR uint8 images: a smooth colour field with bright rectangles."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for _ in range(n):
        img = np.empty((h, w, 3), np.float32)
        for c in range(3):
            fy, fx, ph = rng.uniform(0.002, 0.02, 2).tolist() + [
                rng.uniform(0, 6.3)]
            img[..., c] = 127 + 60 * np.sin(fy * yy + fx * xx + ph)
        for _ in range(12):
            y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
            y1 = min(h, y0 + rng.randint(30, 300))
            x1 = min(w, x0 + rng.randint(30, 400))
            img[y0:y1, x0:x1] = rng.uniform(0, 255, 3)
        img += rng.normal(0, 8, img.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _match_fraction(a, b):
    """Share of ``a``'s detections with one in ``b`` of the same class,
    IoU >= MATCH_IOU and a score within MATCH_SCORE."""
    import numpy as np

    if len(a["boxes"]) == 0:
        return 1.0 if len(b["boxes"]) == 0 else 0.0
    if len(b["boxes"]) == 0:
        return 0.0
    x, y = a["boxes"].astype(np.float64), b["boxes"].astype(np.float64)
    area = lambda t: (t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1])  # noqa
    lt = np.maximum(x[:, None, :2], y[None, :, :2])
    rb = np.minimum(x[:, None, 2:], y[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    union = area(x)[:, None] + area(y)[None, :] - inter
    iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0)
    ok = ((iou >= MATCH_IOU)
          & (a["classes"][:, None] == b["classes"][None, :])
          & (np.abs(a["scores"][:, None] - b["scores"][None, :])
             <= MATCH_SCORE))
    return float(ok.any(axis=1).mean())


def _check_outputs(outs, images, num_classes):
    import numpy as np

    for out, im in zip(outs, images):
        n = len(out["boxes"])
        if out["boxes"].shape != (n, 4) or out["scores"].shape != (n,) \
                or out["classes"].shape != (n,):
            raise PhaseError(f"detection shapes {out['boxes'].shape}")
        if not (np.isfinite(out["boxes"]).all()
                and np.isfinite(out["scores"]).all()):
            raise PhaseError("non-finite detections")
        if n and (out["classes"].max() >= num_classes
                  or out["boxes"][:, 2].max() > im.shape[1] + 1e-3
                  or out["boxes"][:, 3].max() > im.shape[0] + 1e-3
                  or (out["boxes"][:, 2:] < out["boxes"][:, :2]).any()):
            raise PhaseError("detections outside the image or class range")


def _drive(pred, singles, batch):
    """The main path: batch-1 requests, then one predict_batch.
    Returns (outputs, per-request seconds, batch seconds)."""
    import torch

    outs, secs = [], []
    for im in singles:
        t0 = time.perf_counter()
        outs.append(pred(im))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    outs += pred.predict_batch(batch)
    torch.cuda.synchronize()
    return outs, secs, time.perf_counter() - t0


def _reset_counts():
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.nms_cuda import (
        nms_sorted_cuda,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align_cuda import (
        roi_align_cuda,
    )

    nms_sorted_cuda.launches = 0
    roi_align_cuda.launches = 0
    return lambda: {"greedy_nms": nms_sorted_cuda.launches,
                    "roi_align_v2_fwd": roi_align_cuda.launches}


def phase_predictor(profile_dir=None):
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        DefaultPredictor,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops import (
        plain_ops,
    )

    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.MODEL.WEIGHTS = ""  # no checkpoint in the repo: seeded weights
    ncls = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    images = _synthetic_images(1, 11)
    singles, batch = images[:3], images[3:]
    forwards = len(singles) + 1
    chunks = -(-cfg.MODEL.RPN.POST_NMS_TOPK_TEST // cfg.TPU.ROI_CHUNK)
    want = {"greedy_nms": 2 * forwards,  # RPN proposals + final detections
            "roi_align_v2_fwd": chunks * forwards}
    log(f"predictor: {os.path.relpath(CONFIG, ROOT)}, depth "
        f"{cfg.MODEL.RESNETS.DEPTH}, {ncls} classes, images 800x1333 -> "
        f"bucket {tuple(cfg.TPU.IMAGE_BUCKETS[-1])}")

    # float32, TF32 off, deterministic convolutions: kernels vs plain ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    pred = DefaultPredictor(cfg32, seed=0)
    with plain_ops():
        ref, _, _ = _drive(pred, singles, batch)
    read = _reset_counts()
    got, secs, bsec = _drive(pred, singles, batch)
    counts32 = read()
    _check_outputs(got, images, ncls)
    fracs = [min(_match_fraction(g, r), _match_fraction(r, g))
             for g, r in zip(got, ref)]
    log(f"float32 kernels vs plain ops: detections per image "
        f"{[len(o['boxes']) for o in got]} vs "
        f"{[len(o['boxes']) for o in ref]}; matched share (worst way) "
        f"{[round(f, 4) for f in fracs]}; launches {counts32}")
    if min(fracs) < MATCH_FRACTION:
        raise PhaseError(f"float32 detections differ: matched {fracs}")
    if counts32 != want:
        raise PhaseError(f"launches {counts32}, expected {want}")
    del pred
    torch.cuda.empty_cache()

    # bfloat16, the default COMPUTE_DTYPE: the timed main path
    torch.backends.cudnn.deterministic = False
    pred = DefaultPredictor(cfg, seed=0)
    _drive(pred, singles[:1], batch)  # warm-up
    read = _reset_counts()
    got, secs, bsec = _drive(pred, singles, batch)
    counts = read()
    _check_outputs(got, images, ncls)
    if counts != want:
        raise PhaseError(f"launches {counts}, expected {want}")
    log(f"bfloat16 main path: batch-1 requests "
        f"{[round(s * 1e3, 2) for s in secs]} ms, predict_batch(8) "
        f"{bsec * 1e3:.2f} ms ({8 / bsec:.2f} images/s); detections per "
        f"image {[len(o['boxes']) for o in got]}; launches {counts}")
    if profile_dir:
        phase_profile(pred, batch, profile_dir)
    return counts


# ------------------------------------------------- optional: --profile
def _category(name: str) -> str:
    n = name.lower()
    if "fsod_nms" in n:
        return "greedy_nms kernel"
    if "fsod_roi_align" in n:
        return "roi_align kernel"
    if "conv" in n or "xmma" in n or "cudnn" in n or "implicit" in n:
        return "convolution"
    if "gemm" in n or "cutlass" in n:
        return "matmul"
    if "sort" in n or "radix" in n:
        return "sort"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


def phase_profile(pred, batch, out_dir):
    """Device time by kernel of one bf16 predict_batch(8), with
    torch.profiler; the full table goes to ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    by_cat = {}
    for e in kernels:
        us = getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
        by_cat[_category(e.name)] = by_cat.get(_category(e.name), 0) + us
    busy_ms = sum(by_cat.values()) / 1e3
    if busy_ms <= 0:
        log("profile: the profiler saw no device time; not measured")
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_bf16_batch8.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=60))
    shares = {k: round(v / 1e3, 3) for k, v in
              sorted(by_cat.items(), key=lambda kv: -kv[1])}
    log(f"profile bf16 predict_batch(8): wall {wall * 1e3:.2f} ms, device "
        f"busy {busy_ms:.2f} ms (idle share {1 - busy_ms / (wall * 1e3):.3f}"
        f"), device ms by kind {shares}")


# ----------------------------------------------------------------- main
def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import fewshotobjectdetection_imporove_via_text_feature_torch  # noqa
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2

    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    gen = torch.Generator().manual_seed(0)
    phase_build()
    nms = phase_nms(gen)
    roi = phase_roi_align(gen)

    kernels = [
        dict(name="greedy_nms", route="cuda",
             source="fewshotobjectdetection_imporove_via_text_feature_torch/csrc/nms.cu",
             replaces="fewshotobjectdetection_imporove_via_text_feature_tpu/ops/nms_pallas.py:60",
             launches=None, library_ms=None,
             **{k: nms["rpn"][k] for k in
                ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}),
        dict(name="roi_align_v2_fwd", route="cuda",
             source="fewshotobjectdetection_imporove_via_text_feature_torch/csrc/roi_align.cu",
             replaces="fewshotobjectdetection_imporove_via_text_feature_tpu/ops/roi_align_mxu.py:69",
             launches=None, library_ms=None,
             **{k: roi["bfloat16_B8_R256_P7_s2"][k] for k in
                ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}),
    ]
    profile_dir = None
    if "--profile" in argv:
        profile_dir = os.path.abspath(argv[argv.index("--profile") + 1])
    counts = phase_predictor(profile_dir)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
