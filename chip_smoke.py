#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA card,
with its hand-written CUDA kernels, and check what comes out.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --profile DIR  # also profile one bf16 batch of
                                         # 8 (DefaultPredictor and the
                                         # exported artifact) and one bf16
                                         # train step of 16, flagship and
                                         # text; the tables go to DIR

Phases, each of which fails the run on error:
  1. the card's name and power limit (nvidia-smi);
  2. build every kernel from csrc/ with nvcc, one process per source;
  3. greedy NMS: the kernel against its plain PyTorch version on the card,
     keep masks exactly equal, at both call sites' shapes, at 12288 boxes
     and at the training RPN site (batch 2 and 16); prints kept counts,
     128-box tiles visited and kernel launches per call;
  4. ROIAlignV2: the kernel against its plain version, float32 (TF32 off)
     and bfloat16, each within its stated tolerance, at the main path's
     launch shape (8 images x 256 ROIs), at 1000 ROIs on one image, and at
     PCB's P=1 on the 25x42x2048 res5 map;
  5. DefaultPredictor on configs/voc/defrcn_det_r101_base1.yaml at full
     width on seeded random weights: three batch-1 requests and one
     predict_batch of 8 in float32, set-matched against the same port run
     through the plain ops on the card, then timed in bfloat16 (the default
     COMPUTE_DTYPE). The launch counters are set to 0 just before each run
     and read just after; both runs must show every kernel launched, NMS
     twice a forward (RPN proposals and final detections);
  6. phases 3 and 4 again on the main path's own inputs: the arguments of
     every kernel call in one more bf16 predict_batch of 8, captured;
  7. the ROIAlign backward kernel against the autograd of the plain
     version, float32 (TF32 off) within 1e-5 of the gradient's largest
     value and bfloat16 within one bf16 step more, and a second launch on
     the same inputs bitwise equal to the first, at the training launch
     shape (16 images x 256 ROIs, P 7, bin_stride 2), at 1000 ROIs on one
     image (P 7, bin_stride 1), at PCB's P=1, with C = 60, with an
     unaligned gradient, and at the training shape with every ROI covering
     most of the map (the most ROIs a tile of the kernel gathers);
  8. the Trainer on the same config at full width on seeded weights and
     synthetic 800x1344 batches (1-20 GT boxes an image): (a) float32,
     batch 2, one step through the kernels against one through the plain
     ops with the same generators (proposals and sampled ROIs equal, losses
     within 1e-5, five gradients within 1e-4 of their largest values);
     (b) bfloat16 at SOLVER.IMS_PER_BATCH 16, 2 warm-up and 10 timed
     steps, each ended by a CUDA event (no synchronize between steps),
     every loss finite, launches per step NMS 1, ROIAlign forward 2 and
     backward 2; (c) phases 3, 4 and 7 again on the training path's own
     inputs: the arguments of every kernel call in one more bf16 step,
     captured;
  9. the few-shot workflow through the port's CLI (``cli.setup``, the
     ``Trainer`` as ``cli.do_train`` builds it, ``cli.main``) on the same
     config at full width, its own INPUT sizes, its three IMAGE_BUCKETS
     and IMS_PER_BATCH 16, bf16, on synthetic VOC made by the port's maker
     (800 images of 500x375 a year), MODEL.WEIGHTS a synthetic Caffe2
     ImageNet R-101 .pkl (every blob under its real name; the matched and
     unmatched counts printed, every backbone and res5 tensor of the
     Trainer's model equal to its blob) and TEST.PCB_MODELPATH a synthetic
     torchvision R-101 .pth (522 tensors), both from the port's weight
     maker: the train loader alone (images/s); 20
     base-training steps fed by the loader, each ended by a CUDA event, the
     first step of each bucket apart; with --profile, one loader-fed step
     profiled (after 3 that warm the loader); phases 3, 4 and 7 again on
     one loader-fed step's own inputs, and that batch stepped 5 times more
     with no loader and 5 times with a loader decoding beside it; randinit
     surgery 15 -> 20 classes; the gfsod 1-shot seed-0 config
     (tools/create_config.py, into a copy of configs/); 4 fine-tune steps
     and the evaluation of the 800 test images at the CLI's batch of 32
     with PCB on, as the config sets it, SCORE_THRESH_TEST and PCB_LOWER
     at 0 (EVAL_THRESHOLDS: a random detector keeps no box at 0.05);
     images/s over the last 20 batches, the prototype build time, PCB's
     ROIAlign launches a batch, bAP50/nAP50 finite, the log.txt copypaste
     contract; the same
     evaluation with PCB off (images/s); phases 3 and 4 again on one
     evaluation batch's own inputs (the fine-tuned 20-class model, batch
     32), PCB's ROIAlign calls on that batch included (float32), and that
     batch's PCB scores through the kernels against plain_ops() (float32,
     TF32 off, within 1e-5); tools/extract_results.py. Launches are counted
     over the training, over the fine-tune with its evaluation and over the
     evaluation with PCB off, each against its expected count, PCB's
     included;
 10. COCO at 80 classes, through the CLI at full width: synthetic COCO
     (the port's maker: the cocosplit layout, a 1-shot seed, 256 test
     images of 640x480); a seeded 60-class model saved as a detectron2
     .pth (numpy arrays under "model") and read back by the importer;
     randinit surgery 60 -> 80; the gfsod 1-shot seed-0 config; 2 fine-tune
     steps and the evaluation at the CLI's batch of 32 with PCB on (COCO's
     60 base classes excluded; EVAL_THRESHOLDS): AP, bAP and nAP finite,
     images/s, launches
     against their expected counts; the kernels again on one COCO
     evaluation batch's own inputs (the final NMS site at 80 classes, the
     res5 and PCB ROIAlign calls) and its PCB scores against plain_ops();
 11. the text families at full width on the same config, with the text
     head of run_text_train_student.sh (TextRes5ROIHeads, DISTILLATE, KL,
     L2, KL_TEMP 5; synthetic GloVe-300 vectors): (a) float32 batch 2, one
     step through the kernels against one through the plain ops
     (proposals and sampled ROIs equal, every loss within 1e-5 relative,
     the teacher's and the distillation's included, four gradients within
     1e-4 of their largest values); (b) bf16 at IMS_PER_BATCH 16, 2
     warm-up and 5 timed steps (CUDA events), median beside phase 8 (b)'s,
     peak memory, launches per step NMS 1 / ROIAlign 2 / backward 2; the
     cross-ROI attention timed alone at the step's 8192 ROIs; with
     --profile one profiled text step, its device time split into the
     operations over the 8193 keys (QK^T, softmax, AV), the rest of the
     text head (the difference from phase 8 (b)'s profiled step) and the
     kernels; (e) the kernels again on one more text step's own inputs;
     (c) DefaultPredictor on the text config (the student): float32
     against the plain ops, bf16 timed, NMS twice a forward; (d) the
     meta-archs that paint GT (Semantic, Distillated with the cross-output
     head, TextAtt with pixel attention over 50x84 cells an image): one
     bf16 step at batch 16 after a warm-up and one GT-fed forward_inference
     of 8, against the same forward without GT (different where GT is
     painted, equal for Distillated), launches as expected; (f) the text
     recipe through the CLI on phase 9's synthetic VOC: teacher base
     training (4 steps), randinit 15 -> 20, reset_student, the gfsod 1-shot
     config with the student flags (2 steps) and the evaluation of the 800
     test images at 32 with PCB (EVAL_THRESHOLDS): bAP50/nAP50 finite,
     images/s, launches as expected;
 12. the serving entry points on the same config at full width and depth,
     seeded weights: (a) ``torch.export`` artifacts (``engine/export.py``),
     float32 at 800x1344 batch 1 and 8, bfloat16 at the three
     IMAGE_BUCKETS at batch 1 and 800x1344 at batch 8, each export's
     seconds; (b) ``ServingPredictor`` on the card: one exported forward
     launches NMS and the ROIAlign forward as often as DefaultPredictor's,
     float32 detections set-matched against DefaultPredictor's on the same
     weights and images (phase 5's criterion), bf16 requests and
     predict_batch(8) timed beside DefaultPredictor's; (c) two
     ``DetectionServer``s on localhost (float32: over the artifact with
     max_batch 8, over DefaultPredictor with max_batch 1), 24 concurrent
     JPEG requests of the three bucket sizes, every response set-matched
     against DefaultPredictor on the decoded image, requests/s and p50/p99
     ms; (d) TPU.DEVICE_PREPROCESS: ``device_resize_batch`` on the card
     against the CPU (within 1e-3 on the 0-255 scale) and 3 bf16 Trainer
     steps at batch 16 on raw 500x375 batches (CUDA events);
 13. StandardROIHeads (NUM_FC 2) on the same config: (a) float32 batch 2,
     kernels against the plain ops as in phase 8 (a), one ROIAlign launch
     a step at P 7, bin_stride 1, on res4's 1024 channels; (b) bf16 at
     batch 16, 2 warm-up and 5 timed steps, peak memory; (c) the ROIAlign
     forward and backward at bin_stride 1 on one more step's own inputs
     against their plain versions, timed with their bounds; its serving
     path in bf16 (NMS twice and ROIAlign once a forward); (d) one bf16
     step with TPU.REMAT_BACKBONE on the batch of one without: losses
     equal, peak memory of each;
 14. multi-device on the same config at full width and depth (the card's
     machine has one card, and NCCL refuses two ranks on one GPU: two
     gloo ranks share cuda:0 for (a)-(c) and (e), in one spawn through
     ``engine/launch.py``, and NCCL runs at world 1 for (d)): (a) a DDP
     float32 step (TF32 off) at global batch 2, one image a rank, the
     second image 160x224 so the ranks sample different numbers of valid
     ROIs, against one process's step on the same batch and generators
     (sampled ROIs equal, losses within 1e-5 relative, five gradients
     within 1e-4 of their largest values, launches NMS 1 / ROIAlign 2 /
     backward 2 a rank); (b) the same for the text student step, whose
     teacher attends over both ranks' ROIs; (c) TPU.MODEL_PARALLEL 2
     (FSDP2, mesh (1, 2)) on the same ranks: losses and gradients equal
     (a)'s, parameter and momentum bytes by rank beside DP's, its
     checkpoint gathered to rank 0 and read back at world 1; (d) NCCL at
     world 1: 2 warm-up and 5 timed bf16 DDP steps at batch 16 (CUDA
     events), median beside phase 8 (b)'s, peak memory, launches per
     step, then phases 3, 4 and 7 on one more step's own inputs; (e) phase
     9's fine-tuned model evaluated on its 800 test images at 32 a batch,
     PCB off, sharded over the two gloo ranks through the CLI's per-rank
     body: bAP50 and nAP50 equal on both ranks and to phase 9's single
     process, each rank decoding only its own batches, launches summed
     over the ranks equal to phase 9's, images/s;
 15. the learning checks, through ``tools/overfit_map_check.main`` in
     process: (a) ``--production --pcb``, the flagship at full width
     (R-101 at 800x1344, FREEZE_AT 0, batch 6, bf16) trained 300 steps on
     6 synthetic images of coloured rectangles and evaluated on them:
     recall@0.5 >= 0.9 and AP50 > 12, then PCB on seeded ResNet weights
     rescoring every in-window score and no other, recall kept; AP50,
     recall, PCB's counts, the step median, peak memory and wall printed;
     (b) phases 3, 4 and 7 on (a)'s own inputs: one more batch-6 train
     step (NMS at 6 x 12000, ROIAlign forward and backward), one
     evaluation batch (NMS at both sites, ROIAlign) and PCB's ROIAlign on
     that batch's detections; (c) ``--production --head
     TextRes5ROIHeads`` (teacher and student, the student evaluated), and
     the kernels on one more of its steps. A failed assert of the tool
     fails the run.
 16. TPU.SPATIAL_PARTITION: the flagship's backbone in S row bands with a
     halo exchange before every layer that reads neighbouring rows, res4
     gathered before the RPN, on seeded weights whose conv3s are not zero:
     (a) DefaultPredictor refuses S above the visible cards with the JAX
     package's ValueError (the bands then all run on cuda:0); (b) float32,
     TF32 off, S 2 and 4: banded res4 within 1e-4 of the whole backbone's
     largest value, one request and one predict_batch(4) set-matched
     against S 1, NMS and ROIAlign launched as at S 1; (c) bf16 at S 1, 2
     and 4: request ms (median of 10), peak memory, the halo bytes of one
     request.

 17. held-out generalization: (a) the flagship chain of the port's VOC
     gate (``…_torch/tools/check_generalization.sh``, legs base, control,
     ft and stats, with the JAX package's floors and margins) as a
     subprocess on the card: a non-zero exit or a missing ``PAIRED STATS
     OK`` / ``GENERALIZATION GATE PASSED`` fails the run; base AP50,
     control nAP50, ft bAP50/nAP50, drop, gain and each leg's wall time
     printed, the launches of its CLI processes read from the files they
     append at exit (``FSODTF_LAUNCH_COUNTS``) and held to the steps and
     evaluation batches; (b) phases 3, 4 and 7 on the inputs of one step
     of the gate's base config, at the gate's tiny profile and at full
     R-101 width (its width options dropped, its 288x384 bucket and data
     kept), float32; (c) ``…_torch/tools/train_pcb_extractor`` at its
     defaults on the gate's data: final accuracy >= 0.7, then
     ``PrototypicalCalibrationBlock`` loads the ``.pth`` with its 522
     tensors matched.
 18. the card against the CPU on phase 17's gate, float32 with TF32 off
     (``…_torch/tools/card_vs_cpu.py``): (a) step 0 of the clean gfsod
     fine-tune from its surgered checkpoint, on one decoded batch with the
     sampling and dropout drawn on the host, on both devices: losses within
     1e-5 relative, gradients within 1e-4 of their largest value; (b) 20
     steps in lockstep, each step's losses printed, the largest relative
     gap within 1e-2, as many anchors and ROIs sampled on both; (c) its
     fine-tuned checkpoint evaluated on both devices, strict bAP within
     0.3; (d) the Trainer's float32 steps (``exact_float32``) run twice on
     the card over the same 20 batches, losses and parameters bitwise
     equal; launches held to the steps and evaluation batches.
 19. the default compute dtype, bfloat16, on the card against the CPU, the
     port alone (C the card's bf16, T' the CPU's bf16, R' the CPU's
     float32; rule 1 per tensor e(C) <= 2 e(T') + u with e(X) =
     max|X - R'| / max|R'| and u = 2**-8, rule 2 the same sets on both
     devices from the same bf16-rounded head outputs, rule 3 C matching
     at least as many valid detections in T' (IoU > 0.9, same class) as T'
     matches in R'): (a) every case of tests/test_torch_bf16_*.py at their
     tiny size on seeded, perturbed weights: res4 and pooled features with
     stride_in_1x1 both ways, the RPN head, forward_inference padded and
     unpadded (StandardROIHeads too), predict_batch, a device-preprocessed
     batch, an exported bf16 program served on the card, every loss and
     gradient of the flagship and of the Text, TextAtt, Semantic and
     Distillated meta-archs and their inference, each parameter's update
     after 3 SGD steps, proposal selection and final detections from the
     same bf16 head outputs; then (a) again with every NMS and ROIAlign
     forward and backward call captured and held to its plain version;
     (b) full R-101 width at the 512x864 bucket, seeded weights with the
     conv3s drawn: one image through DefaultPredictor (res4, pooled
     features, detections) and one training step at batch 2 with host
     draws (every loss, nine gradients); each comparison's two sides
     printed, a failure of any fails the run.
 20. the repository's entry points on the port, on phase 9's synthetic VOC,
     phase 10's synthetic COCO and phase 9's full-size seeded Caffe2 R-101
     .pkl and torchvision .pth: (a) ``…_torch/tools/preflight_real_voc``
     and ``preflight_real_coco`` as the run scripts call them: the weight
     items OK, the synthetic trees refused, exit 1 with "Nothing was
     started."; ``…_torch/tools/run_real_voc.sh`` stops at that gate with
     no output directory; (b) from a scratch working directory whose
     configs/voc/defrcn_det_r101_base1.yaml is the shipped config with
     ENTRY_STEPS steps, PCB on and EVAL_THRESHOLDS, with
     tools/create_config.py and extract_results.py linked in and
     datasets/ phase 9's images with each year's sets cut to their first
     ENTRY_IMAGES: ``generate_class_embeddings``, then
     ``run_text_train_teacher.sh`` (teacher base training at full width in
     bf16, randinit surgery) and ``run_visualize.sh`` (``--eval-only`` with
     PCB, then the predictions drawn), unmodified, then
     ``visualize_confusion_matrix``: every file written, AP50 finite, the
     launches of both CLI processes held to their steps and evaluation
     batches (``FSODTF_LAUNCH_COUNTS``); (c) every NMS and ROIAlign forward
     and backward call of one more training step of the teacher from its
     trained weights, and of one evaluation batch with PCB, against the
     plain versions (phases 9 and 11's checks).

Kernel times are those of a call enqueued from Python, as the main path
makes it (the mean over back-to-back calls on the stream); each is printed
beside the device time of one call replayed from a CUDA graph.

Prints one JSON line with every kernel's numbers (launches summed over the
main paths of phases 5, 8 (b) and 9-20, by path, PCB's apart, launches per
train step, and the ROIAlign kernels' numbers at StandardROIHeads'
bin_stride 1),
then the card's name and power limit, then as the last line
{"ok": true, "device": {...}}. Exits
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
# ROIAlign backward: float32 within 1e-5 of the gradient's largest value
# (kernel and plain version sum in different orders); bf16 within one bf16
# step more
ROI_BWD_F32_ATOL = 1e-5
ROI_BWD_BF16_RTOL = 2.0 ** -7
# training step, float32, kernels vs plain ops
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4  # of each gradient's largest value
TRAIN_GRADS = ("affine_rcnn.weight", "backbone.res4.0.conv3.weight",
               "roi_heads.res5.0.conv3.weight",
               "proposal_generator.rpn_head.conv.weight",
               "roi_heads.box_predictor.cls_score.weight")
# PCB's rescored scores, float32 with TF32 off, kernels vs plain ops: the
# ROIAlign outputs differ by summation order only (ROI_F32_TOL), and a
# cosine of 1000-d vectors carries that through at about the same size
PCB_SCORE_TOL = 1e-5
# end to end, float32, kernels vs plain ops: a detection matches when a
# detection of the other run has its class, IoU >= 0.9 and a score within
# 1e-3; at least 95% of each run's detections must match, per image
MATCH_IOU, MATCH_SCORE, MATCH_FRACTION = 0.9, 1e-3, 0.95


# the kernels, in the order of the launch counters
KERNEL_NAMES = ("greedy_nms", "roi_align_v2_fwd", "roi_align_v2_bwd")


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


def graph_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn``: the call is captured once into a
    CUDA graph and the graph replayed ``reps`` times, so the host's
    enqueue time (Python, ctypes, one launch per chunk) is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


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
    tested against the boxes kept before it (a box is visited when its
    128-box tile is)."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.nms import (
        TILE,
        tiles_visited,
    )

    b, n = keep.shape
    kept_before = torch.cumsum(keep.long(), dim=1) - keep.long()
    tiles = torch.tensor(tiles_visited(keep, max_keep), device=keep.device)
    tile_of = torch.arange(n, device=keep.device) // TILE
    visited = tile_of[None, :] < tiles[:, None]
    return int((kept_before * (visited & valid)).sum())


def nms_inputs(gen):
    """Phase 3's cases: (label, boxes, valid, IoU, max_keep) on the card.
    The first three draw from ``gen`` (seed 0) as they always did; later
    cases have generators of their own, so earlier inputs stay."""
    import torch

    cases = [
        ("rpn", 8, 6000, 0.7, 1000, False, gen),
        ("final", 8, 2048, 0.5, 100, True, gen),
        ("n12288", 2, 12288, 0.7, None, False, gen),
        ("train_rpn", 2, 12000, 0.7, 2000, False,
         torch.Generator().manual_seed(2)),
        # the training RPN site at the config's IMS_PER_BATCH
        ("train_rpn_b16", 16, 12000, 0.7, 2000, False,
         torch.Generator().manual_seed(4)),
    ]
    out = []
    for name, b, n, thr, mk, class_offset, g in cases:
        boxes, valid = _scene_boxes(g, b, n)
        if class_offset:  # batched_nms_fixed's shift, 15 classes
            cls = torch.randint(0, 15, (b, n), generator=g).float()
            vb = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
            unit = vb.amax(dim=(1, 2)) + 1.0
            boxes = boxes + (cls * unit[:, None])[..., None]
        out.append((name, boxes.cuda(), valid.cuda(), thr, mk))
    return out


def check_nms(name, boxes, valid, thr, mk):
    """The kernel against its plain version (keep masks exactly equal), then
    timed: ``ms`` is a call enqueued from Python, as the main path makes it
    (the mean over back-to-back calls); ``graph_ms`` is a CUDA-graph replay
    of one call, the device time alone."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.nms import (
        nms_sorted_plain,
        tiles_visited,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.nms_cuda import (
        kernel_launches_per_call,
        nms_sorted_cuda,
    )

    b, n = valid.shape
    k_cuda = nms_sorted_cuda(boxes, valid, thr, mk)
    k_plain = nms_sorted_plain(boxes, valid, thr, mk)
    torch.cuda.synchronize()
    diff = int((k_cuda != k_plain).sum())
    if diff:
        raise PhaseError(f"nms[{name}]: {diff} keep flags differ")
    ms = time_ms(lambda: nms_sorted_cuda(boxes, valid, thr, mk), 20)
    g_ms = graph_ms(lambda: nms_sorted_cuda(boxes, valid, thr, mk), 20)
    plain_ms = time_ms(lambda: nms_sorted_plain(boxes, valid, thr, mk), 2)
    pairs = _nms_pairs_needed(k_plain, valid, mk)
    nbytes = b * n * (16 + 1) + b * n
    bound_ops = 12.0 * pairs / F32_FLOPS * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    res = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms, max_abs_err=0.0,
               bound_ms=max(bound_ops, bound_bytes),
               bound_by="operations" if bound_ops >= bound_bytes else "bytes")
    log(f"nms[{name}] B={b} N={n} iou={thr} max_keep={mk}: masks equal; "
        f"kept {[int(k) for k in k_plain.sum(dim=1)]}, tiles visited "
        f"{tiles_visited(k_plain, mk)} of {-(-n // 128)}, "
        f"{kernel_launches_per_call(n)} kernel launches a call; kernel "
        f"{ms:.4f} ms a call enqueued from Python ({g_ms:.4f} ms graph "
        f"replay), plain {plain_ms:.3f} ms, bound {res['bound_ms']:.5f} ms")
    return res


def phase_nms(gen):
    """Kernel vs plain version at both call sites' shapes (RPN proposals at
    test time, final detections with the class offset), at 12288 boxes
    without max_keep, and at the training RPN site."""
    return {name: check_nms(name, *rest) for name, *rest in nms_inputs(gen)}


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


def _samples_per_bin(boxes, h, w, p, bin_stride, sampling, scale):
    """Mean bilinear samples a bin (g_y * g_x) over these ROIs."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align import (
        roi_sample_geometry,
    )

    flat = boxes.reshape(-1, 4)
    if flat.shape[0] == 0:
        return 0.0
    geo = roi_sample_geometry(flat, scale, p, sampling, bin_stride,
                              feat_hw=(h, w))
    gy = (geo.wy > 0).sum(dim=1).expand(flat.shape[0])
    gx = (geo.wx > 0).sum(dim=1).expand(flat.shape[0])
    return float((gy * gx).float().mean())


def _tapped_pixels(boxes, h, w, p, bin_stride, sampling, scale):
    """The (image, pixel) pairs that some ROI of the image reads with a
    nonzero weight: the map bytes the function must read are these pixels'
    channels, not the whole map. A ROI's emitted bins read the outer
    product of the rows and the columns its bins tap (the nonzero entries
    of the plain version's interpolation matrices)."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align import (
        _interp_matrix,
        roi_sample_geometry,
    )

    b, r = boxes.shape[:2]
    if r == 0:
        return 0
    geo = roi_sample_geometry(boxes.reshape(-1, 4), scale, p, sampling,
                              bin_stride, feat_hw=(h, w))
    rows = (_interp_matrix(geo.y1, geo.bin_h, geo.grid_y, geo.wy, h,
                           geo.p_out, geo.sy) != 0).any(dim=1)
    cols = (_interp_matrix(geo.x1, geo.bin_w, geo.grid_x, geo.wx, w,
                           geo.p_out, geo.sx) != 0).any(dim=1)
    hit = torch.einsum("brh,brw->bhw", rows.reshape(b, r, h).float(),
                       cols.reshape(b, r, w).float())
    return int((hit > 0).sum())


def roi_inputs(gen):
    """Phase 4's cases on a 50x84x1024 map (the res4 map of the 800x1344
    bucket): first the main path's own launch shape (8 images, one 256-ROI
    chunk each, P=7 with bin_stride 2), then 1000 ROIs on one image with and
    without elision, and P=1; last, PCB's P=1 on the 25x42x2048 res5 map at
    1/32. Each in float32 and bfloat16, channels-last as the main path hands
    them over. Returns (key, args of roi_align_cuda, tolerance)."""
    import torch

    cases = [  # (label, images, ROIs per image, P, bin_stride, map)
        ("B8_R256_P7_s2", 8, 256, 7, 2, "res4"),
        ("B1_R1000_P7_s2", 1, 1000, 7, 2, "res4"),
        ("B1_R1000_P7_s1", 1, 1000, 7, 1, "res4"),
        ("B1_R1000_P1_s1", 1, 1000, 1, 1, "res4"),
        ("B1_R100_P1_res5", 1, 100, 1, 1, "res5"),
    ]
    # the res4 map and its boxes draw from ``gen`` (seed 0) as they always
    # did; the res5 case has a generator of its own
    maps = {"res4": (torch.randn(8, 1024, 50, 84, generator=gen).cuda(),
                     1 / 16.0)}
    boxes_of = {(b, r): _roi_boxes(gen, b, r).cuda()
                for _, b, r, _, _, m in cases if m == "res4"}
    g5 = torch.Generator().manual_seed(3)
    maps["res5"] = (torch.randn(1, 2048, 25, 42, generator=g5).cuda(),
                    1 / 32.0)
    boxes_of[(1, 100)] = _roi_boxes(g5, 1, 100).cuda()
    out = []
    for dtype, tol in ((torch.float32, ROI_F32_TOL),
                       (torch.bfloat16, ROI_BF16_TOL)):
        for label, b, r, p, stride, m in cases:
            feat32, scale = maps[m]
            feat = feat32[:b].to(dtype).contiguous(
                memory_format=torch.channels_last)
            out.append((f"{str(dtype).split('.')[-1]}_{label}",
                        (feat, boxes_of[(b, r)], p, scale, 0, stride), tol))
    return out


def check_roi_align(key, args, tol, reps=10):
    """The kernel against its plain version within ``tol``, then timed as
    ``check_nms`` times NMS (``ms`` enqueued from Python, ``graph_ms`` by
    graph replay)."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align import (
        roi_align_plain,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align_cuda import (
        roi_align_cuda,
    )

    feat, boxes, p, scale, sampling, stride = args
    b, c, h, w = feat.shape
    got = roi_align_cuda(*args)
    ref = roi_align_plain(*args)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max()) if got.numel() \
        else 0.0
    if feat.dtype == torch.float32 and b == 1:
        ref64 = roi_align_plain(feat.double(), *args[1:])
        log(f"  vs float64: kernel "
            f"{float((got.double() - ref64).abs().max()):.3g}, plain "
            f"{float((ref.double() - ref64).abs().max()):.3g}")
    if not torch.allclose(got.float(), ref.float(), **tol):
        raise PhaseError(f"roi_align[{key}]: max abs err {err} outside {tol}")
    ms = time_ms(lambda: roi_align_cuda(*args), reps)
    g_ms = graph_ms(lambda: roi_align_cuda(*args), reps)
    plain_ms = time_ms(lambda: roi_align_plain(*args), 3)
    esize = feat.element_size()
    p_out = len(range(0, p, stride))
    # the map pixels the boxes tap (each read once, all its channels), the
    # boxes, the output written once
    tapped = _tapped_pixels(boxes, h, w, p, stride, sampling, scale)
    nbytes = tapped * c * esize + boxes.numel() * 4 \
        + boxes.shape[0] * boxes.shape[1] * p_out * p_out * c * esize
    spb = _samples_per_bin(boxes, h, w, p, stride, sampling, scale)
    # 8 operations a bilinear sample (4 taps, a multiply and an add each)
    # for every output value
    ops = spb * boxes.shape[0] * boxes.shape[1] * p_out * p_out * c * 8.0
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F32_FLOPS * 1e3
    res = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms, max_abs_err=err,
               bound_ms=max(bound_ops, bound_bytes),
               bound_by="operations" if bound_ops >= bound_bytes
               else "bytes")
    log(f"roi_align[{key}] map {b}x{h}x{w}x{c}, {boxes.shape[1]} ROIs an "
        f"image, {spb:.2f} samples a bin, {tapped / (b * h * w):.3f} of the "
        f"map tapped: max abs err {err:.3g} (tol {tol}); "
        f"kernel {ms:.4f} ms a call enqueued from Python ({g_ms:.4f} ms "
        f"graph replay), plain {plain_ms:.3f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']})")
    return res


def phase_roi_align(gen):
    """Kernel vs plain version at every ``roi_inputs`` case."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {key: check_roi_align(key, args, tol)
            for key, args, tol in roi_inputs(gen)}


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

    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align_cuda import (
        roi_align_bwd_cuda,
    )

    nms_sorted_cuda.launches = 0
    roi_align_cuda.launches = 0
    roi_align_bwd_cuda.launches = 0
    return lambda: {"greedy_nms": nms_sorted_cuda.launches,
                    "roi_align_v2_fwd": roi_align_cuda.launches,
                    "roi_align_v2_bwd": roi_align_bwd_cuda.launches}


def phase_predictor(profile_dir=None, opts=(), label="predictor"):
    """Phase 5 on the config with ``opts`` (phase 11: the text head, whose
    serving path runs its student). Returns the bf16 run's launches, the
    kernel calls of one more predict_batch(8), the ROI chunks a forward
    and the bf16 times."""
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
    cfg.merge_from_list(list(opts))
    cfg.MODEL.WEIGHTS = ""  # no checkpoint in the repo: seeded weights
    ncls = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    images = _synthetic_images(1, 11)
    singles, batch = images[:3], images[3:]
    forwards = len(singles) + 1
    chunks = -(-cfg.MODEL.RPN.POST_NMS_TOPK_TEST // cfg.TPU.ROI_CHUNK)
    want = {"greedy_nms": 2 * forwards,  # RPN proposals + final detections
            "roi_align_v2_fwd": chunks * forwards, "roi_align_v2_bwd": 0}
    log(f"{label}: {os.path.relpath(CONFIG, ROOT)} {list(opts)}, depth "
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
    log(f"{label} float32 kernels vs plain ops: detections per image "
        f"{[len(o['boxes']) for o in got]} vs "
        f"{[len(o['boxes']) for o in ref]}; matched share (worst way) "
        f"{[round(f, 4) for f in fracs]}; launches {counts32}")
    if min(fracs) < MATCH_FRACTION:
        raise PhaseError(f"{label} float32 detections differ: matched "
                         f"{fracs}")
    if counts32 != want:
        raise PhaseError(f"{label}: launches {counts32}, expected {want}")
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
        raise PhaseError(f"{label}: launches {counts}, expected {want}")
    log(f"{label} bfloat16 main path: batch-1 requests "
        f"{[round(s * 1e3, 2) for s in secs]} ms, predict_batch(8) "
        f"{bsec * 1e3:.2f} ms ({8 / bsec:.2f} images/s); detections per "
        f"image {[len(o['boxes']) for o in got]}; launches {counts}")
    if profile_dir:
        phase_profile(pred, batch, profile_dir)
    return counts, capture_kernel_inputs(
        lambda: pred.predict_batch(batch)), chunks, {
            "request_ms": [x * 1e3 for x in secs], "batch8_ms": bsec * 1e3}


def capture_kernel_inputs(fn):
    """The arguments of every kernel call that ``fn()`` makes, detached and
    cloned (strides kept): {"nms": [(boxes, valid, iou, max_keep), ...],
    "roi_align": [...], "roi_align_bwd": [...]}. Each wrapper is replaced
    by a recording stand-in for the one call and restored after."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops import (
        nms_cuda,
        roi_align_cuda,
    )

    calls = {"nms": [], "roi_align": [], "roi_align_bwd": []}
    sites = {"nms": (nms_cuda, "nms_sorted_cuda"),
             "roi_align": (roi_align_cuda, "roi_align_cuda"),
             "roi_align_bwd": (roi_align_cuda, "roi_align_bwd_cuda")}

    def recording(kind, wrapped):
        def call(*args):
            calls[kind].append(tuple(
                a.detach().clone() if isinstance(a, torch.Tensor) else a
                for a in args))
            return wrapped(*args)
        # the wrapper counts its launches under its module-level name, which
        # is this stand-in while it is installed
        call.launches = 0
        return call

    saved = {kind: getattr(mod, name) for kind, (mod, name) in sites.items()}
    for kind, (mod, name) in sites.items():
        setattr(mod, name, recording(kind, saved[kind]))
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for kind, (mod, name) in sites.items():
            setattr(mod, name, saved[kind])
    return calls


# ----------------------------------------------------------------- phase 6
def phase_main_path_inputs(calls, chunks, label="main_path"):
    """Phases 3 and 4 again, on an inference path's own inputs: the RPN's
    sorted proposals and the final detections (NMS), and the ROI head's
    proposals on res4 in ``chunks`` launches (ROIAlign), as one bf16
    forward handed them over (phase 6: predict_batch(8); phase 9: one
    evaluation batch)."""
    sites = ("rpn", "final")
    if len(calls["nms"]) != len(sites) or len(calls["roi_align"]) != chunks:
        raise PhaseError(f"{label}: captured {len(calls['nms'])} NMS and "
                         f"{len(calls['roi_align'])} ROIAlign calls")
    nms = {site: check_nms(f"{label}_{site}", *args)
           for site, args in zip(sites, calls["nms"])}
    roi = [check_roi_align(f"{label}_chunk{i}", args, ROI_BF16_TOL)
           for i, args in enumerate(calls["roi_align"])]
    total = {k: sum(r[k] for r in roi) for k in ("ms", "graph_ms")}
    log(f"{label}'s inputs: ROIAlign {len(roi)} launches "
        f"{total['ms']:.4f} ms enqueued from Python ({total['graph_ms']:.4f}"
        f" ms graph replay); NMS RPN site {nms['rpn']['ms']:.4f} ms, final "
        f"site {nms['final']['ms']:.4f} ms")


# ----------------------------------------------------------------- phase 7
def roi_bwd_inputs(gen):
    """Phase 7's cases: (key, (grad_out, boxes, feature shape, P, scale,
    sampling, bin_stride)); the training launch shape first. Each in
    float32 and bfloat16; grad_out is the (B, S, C, P', P') view of an NHWC
    buffer, as the forward hands it back."""
    import torch

    cases = [  # (label, images, ROIs an image, C, H, W, P, stride, scale)
        ("B16_R256_P7_s2", 16, 256, 1024, 50, 84, 7, 2, 1 / 16.0),
        ("B1_R1000_P7_s1", 1, 1000, 1024, 50, 84, 7, 1, 1 / 16.0),
        ("B1_R100_P1_res5", 1, 100, 2048, 25, 42, 1, 1, 1 / 32.0),
        ("B2_R256_P7_s2_C60", 2, 256, 60, 50, 84, 7, 2, 1 / 16.0),
        ("B2_R256_P7_s2_unaligned", 2, 256, 1024, 50, 84, 7, 2, 1 / 16.0),
        ("B16_R256_P7_s2_dense", 16, 256, 1024, 50, 84, 7, 2, 1 / 16.0),
    ]
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, b, r, c, h, w, p, stride, scale in cases:
            # the earlier cases draw from ``gen`` as they always did; the
            # dense case has a generator of its own
            g = gen
            if label.endswith("dense"):
                g = torch.Generator().manual_seed(6)
                boxes = _dense_boxes(g, b, r).cuda()
            else:
                boxes = _roi_boxes(gen, b, r).cuda()
            p_out = len(range(0, p, stride))
            n = b * r * p_out * p_out * c
            skew = 1 if label.endswith("unaligned") else 0
            flat = torch.randn(n + skew, generator=g).to("cuda", dtype)
            g = flat[skew:].view(b, r, p_out, p_out, c).permute(0, 1, 4, 2, 3)
            out.append((f"{str(dtype).split('.')[-1]}_{label}",
                        (g, boxes, (b, c, h, w), p, scale, 0, stride)))
    return out


def _dense_boxes(gen, b, r, img_h=800.0, img_w=1344.0):
    """(b, r, 4) ROIs that each cover 70-100% of the 800x1344 bucket on
    both axes: every tile of the backward kernel gathers every ROI."""
    import torch

    lo = torch.rand(b, r, 2, generator=gen) * 0.15
    hi = 0.85 + torch.rand(b, r, 2, generator=gen) * 0.15
    size = torch.tensor([img_w, img_h])
    return torch.cat([lo * size, hi * size], dim=-1).float()


def _bin_tiles(start, bin_size, grid, wsamp, size, p_out, s, tile):
    """(R, P') the tiles of ``tile`` pixels along one axis that each emitted
    bin's taps meet: the pixels where the plain version's interpolation
    matrix has a weight, which are the kernel's taps."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align import (
        _interp_matrix,
    )

    nz = _interp_matrix(start, bin_size, grid, wsamp, size, p_out, s) != 0
    n_tiles = -(-size // tile)
    nz = torch.nn.functional.pad(nz.to(torch.uint8),
                                 (0, n_tiles * tile - size))
    return nz.reshape(*nz.shape[:2], n_tiles, tile).amax(-1).sum(-1)


def _bwd_design_bytes(g, boxes, shape, p, scale, sampling, stride):
    """The bytes the tiled backward kernel moves: each CTA reads the
    grad_out slab of every bin whose taps meet its tile (so a bin is read
    once per tile it meets, its C channels over the slabs) and writes the
    gradient once; the boxes count once, as in the function's own bytes
    (each CTA reads its image's again, from L2). Returns (bytes, bin-tile
    pairs)."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align import (
        roi_sample_geometry,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align_cuda import (
        BWD_TILE_COLS,
        BWD_TILE_ROWS,
    )

    b, c, h, w = shape
    geo = roi_sample_geometry(boxes.reshape(-1, 4), scale, p, sampling,
                              stride, feat_hw=(h, w))
    ty = _bin_tiles(geo.y1, geo.bin_h, geo.grid_y, geo.wy, h, geo.p_out,
                    geo.sy, BWD_TILE_ROWS)
    tx = _bin_tiles(geo.x1, geo.bin_w, geo.grid_x, geo.wx, w, geo.p_out,
                    geo.sx, BWD_TILE_COLS)
    bin_tiles = int((ty.sum(dim=1) * tx.sum(dim=1)).sum())
    esize = g.element_size()
    return (bin_tiles * c * esize + boxes.numel() * 4
            + b * h * w * c * esize), bin_tiles


def check_roi_align_bwd(key, args, reps=10):
    """The backward kernel against the autograd of the plain version (same
    grad_out, same boxes), and a second launch bitwise equal to the first;
    then timed as phase 4 times the forward; the plain time is its
    backward pass alone."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align import (
        roi_align_plain,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align_cuda import (
        roi_align_bwd_cuda,
    )

    g, boxes, shape, p, scale, sampling, stride = args
    b, c, h, w = shape
    got = roi_align_bwd_cuda(*args)
    feat = torch.zeros(shape, dtype=g.dtype, device="cuda",
                       requires_grad=True)
    out = roi_align_plain(feat, boxes, p, scale, sampling, stride)
    ref = torch.autograd.grad(out, feat, g, retain_graph=True)[0]
    torch.cuda.synchronize()
    ref32 = ref.float()
    err = float((got.float() - ref32).abs().max())
    atol = ROI_BWD_F32_ATOL * float(ref32.abs().max())
    rtol = ROI_BWD_BF16_RTOL if g.dtype == torch.bfloat16 else 0.0
    if not torch.allclose(got.float(), ref32, rtol=rtol, atol=atol):
        raise PhaseError(f"roi_align_bwd[{key}]: max abs err {err} outside "
                         f"rtol {rtol}, atol {atol}")
    bits = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
    again = roi_align_bwd_cuda(*args)
    torch.cuda.synchronize()
    if not torch.equal(got.view(bits), again.view(bits)):
        raise PhaseError(f"roi_align_bwd[{key}]: two launches differ in "
                         f"{int((got.view(bits) != again.view(bits)).sum())}"
                         f" elements")
    del again
    ms = time_ms(lambda: roi_align_bwd_cuda(*args), reps)
    g_ms = graph_ms(lambda: roi_align_bwd_cuda(*args), reps)
    plain_ms = time_ms(lambda: torch.autograd.grad(out, feat, g,
                                                   retain_graph=True), 3)
    del out
    esize = g.element_size()
    map_elems = b * h * w * c
    # the function's own bytes: grad_out and boxes read, the gradient of
    # the map written
    nbytes = g.numel() * esize + boxes.numel() * 4 + map_elems * esize
    design_bytes, bin_tiles = _bwd_design_bytes(*args)
    spb = _samples_per_bin(boxes, h, w, p, stride, sampling, scale)
    p_out = len(range(0, p, stride))
    # 8 operations a bilinear sample: 4 taps, a multiply and an add each
    ops = spb * b * boxes.shape[1] * p_out * p_out * c * 8.0
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / F32_FLOPS * 1e3
    res = dict(ms=ms, graph_ms=g_ms, plain_ms=plain_ms, max_abs_err=err,
               bound_ms=max(bound_ops, bound_bytes),
               bound_by="operations" if bound_ops >= bound_bytes
               else "bytes",
               design_bound_ms=design_bytes / HBM_BYTES_PER_S * 1e3)
    n_bins = b * boxes.shape[1] * p_out * p_out
    log(f"roi_align_bwd[{key}] map {b}x{h}x{w}x{c}, {boxes.shape[1]} ROIs "
        f"an image, {spb:.2f} samples a bin: max abs err {err:.3g} (gradient"
        f" max {float(ref32.abs().max()):.3g}), two launches bitwise equal; "
        f"kernel {ms:.4f} ms a call enqueued from Python ({g_ms:.4f} ms "
        f"graph replay), plain {plain_ms:.3f} ms, bound "
        f"{res['bound_ms']:.4f} ms ({res['bound_by']}), this design's bytes "
        f"(grad_out read once for each of {bin_tiles} bin-tiles, "
        f"{bin_tiles / max(n_bins, 1):.3f} a bin; gradient written once) "
        f"{res['design_bound_ms']:.4f} ms")
    return res


def phase_roi_align_bwd(gen):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {key: check_roi_align_bwd(key, args)
           for key, args in roi_bwd_inputs(gen)}
    # each 256-ROI chunk's backward returns a full-size gradient of the
    # map; autograd adds the two of a training step
    a, b = (torch.zeros(16, 50, 84, 1024, dtype=torch.bfloat16,
                        device="cuda").permute(0, 3, 1, 2) for _ in range(2))
    add_ms = time_ms(lambda: a + b, 10)
    log(f"roi_align_bwd: adding two chunks' bf16 16x1024x50x84 gradients "
        f"(channels-last) {add_ms:.4f} ms, bound "
        f"{3 * a.numel() * 2 / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes)")
    del a, b
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------- phase 8
def train_batches(seed, n_batches, batch, max_gt=100, num_classes=15,
                  h=800, w=1333, bucket=(800, 1344)):
    """Synthetic training batches at the 800x1344 bucket: the phase 5
    images, zero-padded, and 1-20 GT boxes an image (32-400 px, classes in
    [0, num_classes)) padded to ``max_gt``. CPU tensors."""
    import numpy as np
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
        GTInstances,
        ImageBatch,
    )

    rng = np.random.RandomState(seed)
    images = _synthetic_images(seed, n_batches * batch, h, w)
    out = []
    for k in range(n_batches):
        canvas = np.zeros((batch, *bucket, 3), np.uint8)
        boxes = np.zeros((batch, max_gt, 4), np.float32)
        classes = np.zeros((batch, max_gt), np.int32)
        valid = np.zeros((batch, max_gt), bool)
        for i in range(batch):
            canvas[i, :h, :w] = images[k * batch + i]
            n = rng.randint(1, 21)
            wh = rng.uniform(32, 400, (n, 2))
            xy = rng.uniform(0, 1, (n, 2)) * ([w, h] - wh)
            boxes[i, :n] = np.concatenate([xy, xy + wh], 1)
            classes[i, :n] = rng.randint(0, num_classes, n)
            valid[i, :n] = True
        hw = torch.tensor([[h, w]] * batch, dtype=torch.int32)
        out.append((ImageBatch(torch.from_numpy(canvas), hw, hw.clone()),
                    GTInstances(torch.from_numpy(boxes),
                                torch.from_numpy(classes),
                                torch.from_numpy(valid))))
    return out


def _train_cfg(out_dir, dtype, batch, max_iter, opts=()):
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )

    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(list(opts))
    cfg.MODEL.WEIGHTS = ""  # no checkpoint in the repo: seeded weights
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.SOLVER.IMS_PER_BATCH = batch
    cfg.SOLVER.MAX_ITER = max_iter
    cfg.SEED = 0
    cfg.OUTPUT_DIR = out_dir
    return cfg


def _fmt(d):
    return {k: float(f"{v:.3g}") for k, v in d.items()}


def _recording_sampler():
    """Wrap the model's proposal sampler to keep its inputs and outputs;
    returns (records, restore)."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        meta_arch,
    )

    records = []
    fn = meta_arch.label_and_sample_proposals

    def call(proposals, *args, **kwargs):
        out = fn(proposals, *args, **kwargs)
        records.append((proposals.boxes.clone(), proposals.valid.clone(),
                        out["boxes"].clone(), out["valid"].clone()))
        return out

    meta_arch.label_and_sample_proposals = call
    return records, lambda: setattr(meta_arch, "label_and_sample_proposals",
                                    fn)


def phase_train_f32(tmp, opts=(), grads=TRAIN_GRADS, label="train f32",
                    launches=(1, 2, 2)):
    """(a) float32, TF32 off, batch 2: one forward/backward through the
    kernels and one through the plain ops, with the same generators;
    ``opts`` on top of the config (phase 11: the text head; phase 13:
    StandardROIHeads, whose one ROIAlign launch a step gives
    ``launches`` (1, 1, 1))."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        Trainer,
        step_generators,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops import (
        plain_ops,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = _train_cfg(os.path.join(tmp, "f32"), "float32", 2, 1, opts)
    (images, gt), = train_batches(11, 1, 2)
    trainer = Trainer(cfg, [(images, gt)])
    model = trainer.model
    images, gt = images.to("cuda"), gt.to("cuda")

    def run():
        model.zero_grad(set_to_none=True)
        losses = model.forward_train(
            images, gt, *step_generators(trainer.seed, 0, "cuda"))
        sum(v for k, v in losses.items()
            if not k.startswith("metric/")).backward()
        named = dict(model.named_parameters())
        return losses, {n: named[n].grad.clone() for n in grads}

    records, restore = _recording_sampler()
    try:
        read = _reset_counts()
        got, got_g = run()
        counts = read()
        with plain_ops():
            ref, ref_g = run()
    finally:
        restore()
    torch.backends.cudnn.deterministic = False
    (kp, kv, ks, ksv), (pp, pv, ps, psv) = records
    if not (torch.equal(kp, pp) and torch.equal(kv, pv)
            and torch.equal(ks, ps) and torch.equal(ksv, psv)):
        raise PhaseError(f"{label}: proposals or sampled ROIs differ "
                         "between the kernels and the plain ops")
    worst = {}
    for k in ref:
        a, b = float(got[k].detach()), float(ref[k].detach())
        worst[k] = abs(a - b) / max(abs(b), 1e-30)
        if not k.startswith("metric/") and worst[k] > TRAIN_LOSS_RTOL:
            raise PhaseError(f"{label}: {k} {a} vs plain {b}")
    grad_err = {}
    for n in grads:
        scale = float(ref_g[n].abs().max())
        grad_err[n] = float((got_g[n] - ref_g[n]).abs().max()) / max(
            scale, 1e-30)
        if not scale > 0 or grad_err[n] > TRAIN_GRAD_TOL:
            raise PhaseError(f"{label}: gradient of {n} off by "
                             f"{grad_err[n]:.3g} of its max {scale:.3g}")
    losses = {k: round(float(v.detach()), 6) for k, v in got.items()}
    log(f"{label}, batch 2, kernels vs plain ops: proposals "
        f"({int(kv.sum())} valid) and sampled ROIs ({int(ksv.sum())} valid)"
        f" equal; losses {losses}; relative loss differences "
        f"{_fmt(worst)}; gradient differences / max {_fmt(grad_err)}; "
        f"launches {counts}")
    if counts != dict(zip(KERNEL_NAMES, launches)):
        raise PhaseError(f"{label}: launches {counts}")
    del trainer, model
    torch.cuda.empty_cache()
    return got


def _step_end_hook(trainer):
    """A Trainer hook that records a CUDA event at the end of each step and
    keeps the step's losses, with no synchronize, so the loop runs as it
    does unobserved. Returns (hook, events, losses)."""
    import torch

    ends, losses = [], []

    def hook(it):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ends.append(ev)
        losses.append(trainer.last_losses)

    return hook, ends, losses


def _spacings(start, ends):
    """ms between successive CUDA events, the first from ``start``: each
    step's share of the stream, host waits included. Call after a
    synchronize."""
    return [a.elapsed_time(b) for a, b in zip([start, *ends[:-1]], ends)]


def _timed_steps(step, n):
    """``step(k)`` for k < n, each ended by a CUDA event and one
    synchronize after the last; returns the ms of each."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    start.record()
    ends = []
    for k in range(n):
        step(k)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
    torch.cuda.synchronize()
    return _spacings(start, ends)


def _not_finite(losses):
    """Indices of the steps whose losses are not all finite."""
    import math

    return [k for k, d in enumerate(losses)
            if not all(math.isfinite(float(v)) for v in d.values())]


def phase_train_bf16(tmp, warmup=2, timed=10, profile_dir=None, opts=(),
                     label="train bfloat16", profile_tag="bf16_train_step",
                     key_dim=None, launches=(1, 2, 2)):
    """(b) bfloat16 at IMS_PER_BATCH: Trainer.train over warm-up and timed
    steps, each ended by a CUDA event and one synchronize after the run;
    the launch counters span the whole run. With ``profile_dir``, one more
    step is profiled after it. Returns the launches a step with the step
    times and peak memory, the run's launch counts, and a function that
    takes one more step on the first batch (for (c))."""
    import statistics

    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        Trainer,
    )

    base = get_cfg()
    base.merge_from_file(CONFIG)
    batch = base.SOLVER.IMS_PER_BATCH
    steps = warmup + timed
    cfg = _train_cfg(os.path.join(tmp, "bf16"), "bfloat16", batch, steps,
                     opts)
    data = train_batches(12, 2, batch)
    trainer = Trainer(cfg, data)
    hook, ends, losses = _step_end_hook(trainer)
    trainer.hooks.append(hook)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    read = _reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read()
    peak = torch.cuda.max_memory_allocated()
    bad = _not_finite(losses)
    if bad:
        raise PhaseError(f"{label}: non-finite losses at steps {bad}")
    want = {k: n * steps for k, n in zip(KERNEL_NAMES, launches)}
    if counts != want:
        raise PhaseError(f"{label}: launches {counts}, expected {want}")
    step_ms = _spacings(start, ends)[warmup:]
    med = statistics.median(step_ms)
    window = ends[warmup - 1].elapsed_time(ends[-1]) / timed
    last = {k: round(float(v), 5) for k, v in trainer.last_losses.items()}
    log(f"{label} batch {batch} at 800x1344, R-101, resident "
        f"batches: {steps} steps in {wall:.2f} s (model_final saved); step "
        f"ms (CUDA events at step ends, no synchronize between steps) "
        f"median {med:.2f} over steps {warmup}-{steps - 1} "
        f"({batch * 1e3 / med:.2f} images/s), mean over that window "
        f"{window:.2f}, steps {[round(x, 1) for x in step_ms]}; peak "
        f"memory {peak / 2**30:.2f} GiB (max_memory_allocated); launches "
        f"{counts} = per step "
        f"{({k: v // steps for k, v in counts.items()})}; last losses {last}")
    images, gt = (t.to("cuda") for t in data[0])
    profiled = None
    if profile_dir:
        profiled = profile_call(
            f"{label} step, batch {batch}",
            lambda: trainer.train_step(images, gt, steps), profile_dir,
            f"profile_{profile_tag}_{batch}.txt", key_dim=key_dim)
    return ({**{k: v // steps for k, v in counts.items()},
             "median_ms": med, "window_ms": window,
             "peak_gib": peak / 2**30, "profile": profiled,
             "last_losses": sorted(trainer.last_losses)}, counts,
            lambda: trainer.train_step(images, gt, steps + 1))


def phase_train_inputs(calls, label="train_path", launches=(1, 2, 2),
                       fwd_tol=ROI_BF16_TOL):
    """(c) phases 3, 4 and 7 again on the training path's own inputs: the
    RPN's sorted proposals (NMS), both 256-ROI chunks of sampled ROIs on the
    res4 map (ROIAlign forward) and their gradients (backward), as one more
    bf16 step of (b) handed them over (phase 13: StandardROIHeads' one
    launch each at P 7, bin_stride 1, ``launches`` (1, 1, 1); phase 17: a
    float32 step, ``fwd_tol`` ROI_F32_TOL). Returns the forward and
    backward checks' numbers."""
    got = {k: len(v) for k, v in calls.items()}
    if got != dict(zip(("nms", "roi_align", "roi_align_bwd"), launches)):
        raise PhaseError(f"{label}: captured kernel calls {got}")
    nms = check_nms(f"{label}_rpn", *calls["nms"][0])
    fwd = [check_roi_align(f"{label}_chunk{i}", args, fwd_tol)
           for i, args in enumerate(calls["roi_align"])]
    bwd = [check_roi_align_bwd(f"{label}_chunk{i}", args)
           for i, args in enumerate(calls["roi_align_bwd"])]
    log(f"{label}'s inputs: NMS {nms['ms']:.4f} ms; ROIAlign forward "
        f"{sum(r['ms'] for r in fwd):.4f} ms and backward "
        f"{sum(r['ms'] for r in bwd):.4f} ms over {len(fwd)} launches each, "
        f"enqueued from Python")
    return fwd, bwd


# ----------------------------------------------------------------- phase 9
# synthetic VOC images a year: the test set (VOC2007 test) is 25 batches of
# 32, so 20 are timed after the evaluator's 5 warm-up batches; the training
# set (VOC2007 + VOC2012 trainval) fills every bucket's batches many times
WORKFLOW_IMAGES = 800
WORKFLOW_BASE_STEPS = 20
WORKFLOW_FT_STEPS = 4
LOADER_BATCHES = 24  # batches taken from the loader alone
LOADER_SKIP = 8  # of which the first, decoded ahead, are not timed
RESIDENT_STEPS = 5  # one loader batch stepped again, without and with a
# loader decoding beside the steps


# phases 9 and 10's synthetic data, made by the port's makers in processes
# of their own (below the card's phases in priority) while the kernels
# build and phases 3-8 run: the 800 VOC images a year took 50-71 s of a
# run's wall before
_MAKERS = []


def start_maker(tool, *args):
    """``…_torch/tools/<tool>`` started as a process. Returns its handle
    for ``wait_maker``; the process is stopped at exit if still running."""
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PORT_MODULE}.tools.{tool}", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, preexec_fn=lambda: os.nice(10))
    _MAKERS.append(proc)
    return proc, time.perf_counter()


def start_voc(root):
    """Phase 9's VOC: WORKFLOW_IMAGES images of 500x375 a year."""
    return start_maker("make_synthetic_voc", "--root", root, "--images",
                       str(WORKFLOW_IMAGES), "--image-size", "500", "375")


def start_coco(root):
    """Phase 10's COCO: COCO_TRAIN_IMAGES trainval and COCO_TEST_IMAGES
    test images of 640x480."""
    return start_maker("make_synthetic_coco", "--root", root,
                       "--train-images", str(COCO_TRAIN_IMAGES),
                       "--test-images", str(COCO_TEST_IMAGES),
                       "--image-size", "640", "480")


def wait_maker(made, label):
    """Wait for a ``start_maker`` process. Returns (its seconds, the
    seconds waited here)."""
    proc, t0 = made
    t_wait = time.perf_counter()
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise PhaseError(f"{label}: exit {proc.returncode}:\n{out[-2000:]}")
    now = time.perf_counter()
    return now - t0, now - t_wait


# evaluation thresholds of phases 9 and 10: a briefly trained random
# detector scores every box below the configs' SCORE_THRESH_TEST (0.05)
# and keeps none, so PCB would rescore nothing; at 0 each image keeps its
# DETECTIONS_PER_IMAGE (100), as a trained detector does on real images,
# and PCB_LOWER 0 lets PCB rescore them
EVAL_THRESHOLDS = ("MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
                   "TEST.PCB_LOWER", "0.0")


def _workflow_args(config, out_dir, *opts):
    """The CLI's argv: the config's own INPUT sizes, IMAGE_BUCKETS and
    IMS_PER_BATCH, bf16, seeded weights, no periodic checkpoint."""
    return ["--config-file", config, "--opts", "MODEL.WEIGHTS", "",
            "TPU.COMPUTE_DTYPE", "bfloat16", "SEED", "0",
            "SOLVER.CHECKPOINT_PERIOD", "0", "OUTPUT_DIR", out_dir, *opts]


def _drained(loader):
    """Take batches from ``loader`` in a thread and drop them, so that its
    decode threads run flat out beside the caller; returns finish(), which
    stops the thread and returns the batches taken."""
    import threading

    stop, taken = threading.Event(), [0]

    def drain():
        while not stop.is_set():
            next(loader)
            taken[0] += 1

    t = threading.Thread(target=drain, daemon=True)
    t.start()

    def finish():
        stop.set()
        t.join(60)
        return taken[0]

    return finish


def phase_workflow(tmp, tv_pth, profile_dir=None, made=None):
    """The few-shot workflow through the port's CLI at full width, on
    synthetic VOC at 500x375: the loader alone; base training from a
    synthetic Caffe2 ImageNet .pkl, built as cli.do_train builds it, fed by
    the loader, each step ended by a CUDA event; one loader-fed step
    profiled (--profile) and one checked against the plain ops; that batch
    stepped again without and with a loader decoding beside it; randinit
    surgery 15 -> 20 classes; the gfsod 1-shot seed-0 config; a fine-tune
    and the evaluation of the test set with PCB (``tv_pth`` its ResNet)
    through cli.main, then the evaluation again with PCB off; the kernels
    checked on one evaluation batch's own inputs, PCB's calls included;
    extract_results.py. ``made``: a ``start_voc`` handle already making
    the VOC under ``tmp``/datasets (else it is started here). Returns the kernel launches of the
    loader-fed training, of the fine-tune with its evaluation and of the
    evaluation with PCB off, and the numbers to print."""
    import math
    import shutil
    import statistics

    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch import cli
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
        build_detection_test_loader,
        build_detection_train_loader,
        device_batches,
        native_io,
        register_all,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        Trainer,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
        inference_on_dataset,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        model_surgery,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_weights import (
        write_c2_pkl,
    )

    try:
        import PIL
        pil = f"PIL {PIL.__version__}"
    except ImportError:
        pil = "no PIL"
    root = os.path.join(tmp, "datasets")
    made_s, waited = wait_maker(made or start_voc(root),
                                "make_synthetic_voc")
    os.environ["FSODTF_DATASETS"] = root
    log(f"workflow: synthetic VOC, {WORKFLOW_IMAGES} images of 500x375 a "
        f"year, made in {made_s:.1f} s ({waited:.1f} s waited here); {pil}; "
        f"native decode core {'built' if native_io.available() else 'unavailable'}")
    runs = os.path.join(tmp, "runs")
    base_out = os.path.join(runs, "base1")
    # the base config's MODEL.WEIGHTS: an ImageNet R-101 in Caffe2 format
    pkl = os.path.join(tmp, "R-101.pkl")
    blobs = write_c2_pkl(pkl, seed=0)
    cfg = cli.setup(cli.default_argument_parser().parse_args(
        _workflow_args(CONFIG, base_out, "MODEL.WEIGHTS", pkl,
                       "SOLVER.MAX_ITER", str(WORKFLOW_BASE_STEPS))))
    register_all(root)
    batch = cfg.SOLVER.IMS_PER_BATCH
    dev = cfg.MODEL.DEVICE
    pin = dev == "cuda"

    # the loader alone, as the Trainer builds it (its seed, page-locked
    # batches): the same batches the training below takes, so their
    # buckets are the training steps' buckets. Once the first LOADER_SKIP
    # are taken the queue is drained and the rate is the decode threads'
    t0 = time.perf_counter()
    loader = build_detection_train_loader(cfg, seed=cfg.SEED, pin_memory=pin)
    try:
        stamps, shapes = [], []
        for _ in range(LOADER_BATCHES):
            shapes.append(tuple(next(loader)[0].image.shape[1:3]))
            stamps.append(time.perf_counter())
    finally:
        loader.close()
    loader_rate = (LOADER_BATCHES - LOADER_SKIP) * batch / (
        stamps[-1] - stamps[LOADER_SKIP - 1])
    log(f"workflow loader alone: {LOADER_BATCHES} batches of {batch} in "
        f"{stamps[-1] - t0:.3f} s from its start "
        f"({LOADER_BATCHES * batch / (stamps[-1] - t0):.2f} images/s); "
        f"after the first {LOADER_SKIP}, {loader_rate:.2f} images/s "
        f"({cfg.DATALOADER.NUM_WORKERS} decode threads, {os.cpu_count()} "
        f"cores)")

    # 1. base training from the loader, as cli.do_train runs it (no
    # evaluation hook: EVAL_PERIOD is MAX_ITER), each step ended by a CUDA
    # event, one synchronize after the run
    trainer = Trainer(cfg)
    check_c2_import(pkl, blobs, cfg, trainer.model)
    trainer.resume_or_load(resume=False)
    hook, ends, losses = _step_end_hook(trainer)
    trainer.hooks.append(hook)
    read = _reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_counts = read()
    # a step pools its sampled ROIs in chunks of TPU.ROI_CHUNK
    step_chunks = -(-cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
                    // cfg.TPU.ROI_CHUNK)
    want = {"greedy_nms": WORKFLOW_BASE_STEPS,
            "roi_align_v2_fwd": step_chunks * WORKFLOW_BASE_STEPS,
            "roi_align_v2_bwd": step_chunks * WORKFLOW_BASE_STEPS}
    if train_counts != want:
        raise PhaseError(f"workflow base training: launches {train_counts}, "
                         f"expected {want}")
    bad = _not_finite(losses)
    if bad:
        raise PhaseError(f"workflow base training: non-finite losses at "
                         f"steps {bad}")
    shapes = shapes[:WORKFLOW_BASE_STEPS]
    step_ms = _spacings(start, ends)
    first = {}
    for k, s in enumerate(shapes):
        first.setdefault(s, k)
    steady = {s: [step_ms[k] for k in range(len(shapes))
                  if shapes[k] == s and k != first[s]] for s in first}
    med = {s: statistics.median(v) for s, v in steady.items() if v}
    all_steady = [v for vs in steady.values() for v in vs]
    window = ends[0].elapsed_time(ends[-1]) / (len(ends) - 1)
    log(f"workflow base training, bf16 batch {batch}, R-101, loader-fed: "
        f"{WORKFLOW_BASE_STEPS} steps in {wall:.2f} s (loader start and "
        f"model_final included), buckets {shapes}; step ms (CUDA events at "
        f"step ends, no synchronize between steps; the first from before "
        f"train(), loader start included) {[round(x, 1) for x in step_ms]};"
        f" first step of each bucket "
        f"{({s: round(step_ms[k], 1) for s, k in first.items()})} ms; "
        f"median of the others by bucket "
        f"{({s: round(v, 2) for s, v in med.items()})} ms, over all "
        f"buckets {statistics.median(all_steady):.2f} ms; mean over steps "
        f"1-{WORKFLOW_BASE_STEPS - 1} {window:.2f} ms; launches "
        f"{train_counts}; last losses {_fmt(trainer.last_losses)}")

    # one more loader: 3 steps from it to warm it up, then (--profile) one
    # step profiled, fetch included; one step's kernel inputs captured
    loader = build_detection_train_loader(cfg, seed=2, pin_memory=pin)
    feed = device_batches(loader, dev)
    step = 10_000
    try:
        for step in range(step, step + 3):
            trainer.train_step(*next(feed)[:2], step)
        if profile_dir:
            seen = []

            def fed_step():
                images, gt, _ = next(feed)
                seen.append((images, gt))
                trainer.train_step(images, gt, step + 1)

            profile_call(f"bf16 loader-fed train step, batch {batch}",
                         fed_step, profile_dir,
                         f"profile_bf16_loader_step_{batch}.txt")
            log(f"workflow: the profiled loader-fed step's bucket "
                f"{tuple(seen[0][0].image.shape[1:3])}; its batch stepped "
                f"again, resident, profiled next")
            profile_call(f"bf16 resident train step, the same batch",
                         lambda: trainer.train_step(*seen.pop(), step + 1),
                         profile_dir, f"profile_bf16_resident_step_{batch}.txt")
        images, gt, _ = next(feed)
        calls = capture_kernel_inputs(
            lambda: trainer.train_step(images, gt, step + 2))
    finally:
        feed.close()
        loader.close()
    bucket = tuple(images.image.shape[1:3])
    log(f"workflow: kernels on one loader-fed step's own inputs, bucket "
        f"{bucket}")
    phase_train_inputs(calls, "workflow_path")
    del calls
    # that batch stepped again: with no loader, then with a loader whose
    # batches a thread takes and drops, so that its decode threads compete
    # with the step's host work at their full rate (the loader-fed steps
    # ran them at the step's pace)
    step += 3
    alone = _timed_steps(lambda k: trainer.train_step(images, gt, step + k),
                         RESIDENT_STEPS)
    step += RESIDENT_STEPS
    loader = build_detection_train_loader(cfg, seed=3, pin_memory=pin)
    try:
        next(loader)
        finish = _drained(loader)
        t0 = time.perf_counter()
        beside = _timed_steps(
            lambda k: trainer.train_step(images, gt, step + k),
            RESIDENT_STEPS)
        drained = finish() * batch / (time.perf_counter() - t0)
    finally:
        loader.close()
    resident = statistics.median(alone)
    contended = statistics.median(beside)
    log(f"workflow: that batch ({bucket}) stepped {RESIDENT_STEPS} times "
        f"(CUDA events): with no loader {[round(x, 1) for x in alone]} ms, "
        f"median {resident:.2f}; with a loader decoding beside the steps "
        f"({drained:.1f} images/s taken and dropped) "
        f"{[round(x, 1) for x in beside]} ms, median {contended:.2f}; "
        f"loader-fed median in that bucket "
        f"{med.get(bucket, float('nan')):.2f} ms")
    del trainer, images, gt
    torch.cuda.empty_cache()

    # 2. surgery, 3. the per-seed config in a copy of configs/
    surgery = model_surgery.main([
        "--dataset", "voc", "--method", "randinit", "--src-path",
        os.path.join(base_out, "model_final.pth"), "--save-dir", base_out])
    shutil.copytree(os.path.join(ROOT, "configs"),
                    os.path.join(tmp, "configs"))
    _run_script("create_config.py", "--dataset", "voc", "--config_root",
                os.path.join(tmp, "configs", "voc"), "--shot", "1",
                "--seed", "0", "--setting", "gfsod", "--split", "1")
    ft_config = os.path.join(tmp, "configs", "voc",
                             "defrcn_gfsod_r101_novel1_1shot_seed0.yaml")

    # 4. fine-tune, then the evaluation with PCB (as the config sets it),
    # through cli.main; then the same evaluation with PCB off
    ft_out = os.path.join(runs, "1shot_seed0")
    read = _reset_counts()
    results = cli.main(_workflow_args(
        ft_config, ft_out, "MODEL.WEIGHTS", surgery, "SOLVER.MAX_ITER",
        str(WORKFLOW_FT_STEPS), "TEST.PCB_MODELPATH", tv_pth,
        *EVAL_THRESHOLDS))
    ft_counts = read()
    timing = inference_on_dataset.last_timing
    bbox = results["voc_2007_test_all1"]["bbox"]
    n_images = timing["images"]
    batches = -(-n_images // cli.EVAL_BATCH_SIZE)
    chunks = -(-cfg.MODEL.RPN.POST_NMS_TOPK_TEST // cfg.TPU.ROI_CHUNK)
    ft_cfg = get_cfg()
    ft_cfg.merge_from_file(ft_config)
    proto_launches, batch_launches = pcb_expected_launches(ft_cfg)
    want = {"greedy_nms": WORKFLOW_FT_STEPS + 2 * batches,
            "roi_align_v2_fwd": step_chunks * WORKFLOW_FT_STEPS
            + chunks * batches + proto_launches + batch_launches * batches,
            "roi_align_v2_bwd": step_chunks * WORKFLOW_FT_STEPS}
    if ft_counts != want:
        raise PhaseError(f"workflow fine-tune + eval: launches {ft_counts}, "
                         f"expected {want}")
    if n_images != WORKFLOW_IMAGES or not all(
            math.isfinite(bbox[k]) for k in ("bAP50", "nAP50")):
        raise PhaseError(f"workflow eval: {n_images} images, {bbox}")
    lines = [ln.strip() for ln in open(os.path.join(ft_out, "log.txt"))
             if ln.strip()]
    if not ("copypaste" in lines[-1] and "copypaste" in lines[-2]):
        raise PhaseError(f"workflow log.txt ends {lines[-2:]}")
    pcb_nums = _pcb_numbers(timing, proto_launches, batch_launches, batches)
    log(f"workflow fine-tune ({WORKFLOW_FT_STEPS} steps, 20 classes) and "
        f"evaluation of {n_images} test images at batch "
        f"{cli.EVAL_BATCH_SIZE}, PCB on: {1 / timing['s_per_image']:.2f} "
        f"images/s over the last {timing['timed_images']} (the first 5 "
        f"batches left out), {1 / timing['wall_s_per_image']:.2f} images/s "
        f"wall; PCB {timing['pcb_s']:.3f} s in execute_calibration, "
        f"{pcb_nums['share_of_eval_wall']:.4f} of the wall; launches "
        f"{ft_counts} as expected (PCB's ROIAlign: {proto_launches} for the "
        f"prototypes, {batch_launches} a batch, from the dataset dicts); "
        f"bAP50 {bbox['bAP50']:.4f}, nAP50 "
        f"{bbox['nAP50']:.4f} (seeded weights: plumbing, not accuracy)")
    for ln in lines[-3:]:
        log(f"workflow log.txt: {ln.split(': ', 1)[-1]}")
    final = os.path.join(ft_out, "model_final.pth")
    read = _reset_counts()
    off_results = cli.main(["--eval-only"] + _workflow_args(
        ft_config, os.path.join(runs, "pcb_off"), "MODEL.WEIGHTS", final,
        "TEST.PCB_ENABLE", "False", *EVAL_THRESHOLDS))
    off_counts = read()
    off = inference_on_dataset.last_timing
    want = {"greedy_nms": 2 * batches, "roi_align_v2_fwd": chunks * batches,
            "roi_align_v2_bwd": 0}
    if off_counts != want:
        raise PhaseError(f"workflow eval, PCB off: launches {off_counts}, "
                         f"expected {want}")
    pcb_nums["off_images_per_s"] = 1 / off["s_per_image"]
    pcb_nums["on_images_per_s"] = 1 / timing["s_per_image"]
    log(f"workflow evaluation of the same {off['images']} images, PCB off: "
        f"{1 / off['s_per_image']:.2f} images/s over the last "
        f"{off['timed_images']}, {1 / off['wall_s_per_image']:.2f} images/s "
        f"wall (PCB on: {1 / timing['s_per_image']:.2f} and "
        f"{1 / timing['wall_s_per_image']:.2f}); PCB's share of the wall "
        f"time by the two runs "
        f"{1 - off['wall_s_per_image'] / timing['wall_s_per_image']:.4f}; "
        f"launches {off_counts}")

    # the kernels on one evaluation batch's own inputs: the fine-tuned
    # 20-class model at the CLI's evaluation batch, and PCB on its
    # detections
    pcb_nums.update(check_eval_batch(ft_config, final, "voc_2007_test_all1",
                                     tv_pth, chunks, "eval_path"))
    torch.cuda.empty_cache()

    # 5. aggregate
    _run_script("extract_results.py", "--res-dir", runs, "--shot-list", "1")
    table = open(os.path.join(runs, "results.txt")).read()
    if "1-shot" not in table:
        raise PhaseError(f"extract_results: {table}")
    for ln in table.strip().splitlines():
        log(f"workflow results.txt: {ln}")
    return train_counts, ft_counts, off_counts, dict(
        loader_images_per_s=loader_rate,
        fed_step_ms=statistics.median(all_steady), fed_step_ms_by_bucket=med,
        fed_window_ms=window, resident_bucket=bucket, resident_ms=resident,
        contended_ms=contended, eval_batch=cli.EVAL_BATCH_SIZE,
        eval_images_per_s=1 / timing["s_per_image"], pcb=pcb_nums,
        datasets=root, ft_config=ft_config, final=final, pkl=pkl,
        off_bbox=off_results["voc_2007_test_all1"]["bbox"],
        off_counts=off_counts, off_images_per_s=1 / off["s_per_image"])


def _plain_copies(calls):
    """Captured kernel arguments made in inference mode, copied again as
    plain tensors."""
    import torch

    return {k: [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                      for a in args) for args in v]
            for k, v in calls.items()}


def check_c2_import(pkl, blobs, cfg, model):
    """The Caffe2 file through the importer into a model of ``cfg`` (the
    matched and unmatched counts), and ``model`` (the Trainer's, built
    from MODEL.WEIGHTS) holding every backbone and res5 tensor of it."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
        load_reference_weights,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint.torch_import import (
        c2_to_d2,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        build_model,
    )

    matched, skipped = load_reference_weights(pkl, build_model(cfg))
    state = model.state_dict()
    targets = [k for k in state
               if k.startswith(("backbone.", "roi_heads.res5."))
               and not k.endswith(("running_mean", "running_var"))]
    named = {c2_to_d2(n): v for n, v in blobs.items()
             if c2_to_d2(n) is not None}
    wrong = [k for k in targets if k not in named or not torch.equal(
        state[k].cpu(), torch.from_numpy(named[k]))]
    log(f"workflow: MODEL.WEIGHTS a synthetic Caffe2 ImageNet R-101 "
        f"({len(blobs)} blobs under their real names): {matched} matched, "
        f"{len(skipped)} unmatched {sorted(skipped)}; the Trainer's model "
        f"holds {len(targets) - len(wrong)} of its {len(targets)} backbone "
        f"and res5 tensors (convolutions, FrozenBN scales and shifts) "
        f"equal to their blobs")
    if matched != len(targets) or wrong or sorted(skipped) != [
            "pred_b", "pred_w"]:
        raise PhaseError(f"Caffe2 import: matched {matched} of "
                         f"{len(targets)}, unmatched {skipped}, not loaded "
                         f"{wrong[:5]}")


def _pcb_pad(rec):
    """PCB's padded size of a record's image: each side rounded up to 64."""
    return -(-rec["height"] // 64) * 64, -(-rec["width"] // 64) * 64


def pcb_expected_launches(cfg):
    """PCB's ROIAlign launches, worked out from the dataset dicts (not from
    PCB's own counter): one for each padded size in each chunk of
    SUPPORT_CHUNK support images, for the prototypes; then one for each
    padded size among an evaluation batch's images. The synthetic test
    sets hold one image size (checked), so that is one a batch: at
    EVAL_THRESHOLDS every test image has detections in PCB's window.
    Returns (prototype launches, launches an evaluation batch)."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
        get_detection_dataset_dicts,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation.pcb import (
        SUPPORT_CHUNK,
    )

    support = [r for r in get_detection_dataset_dicts(
        [cfg.DATASETS.TRAIN[0]], filter_empty=True) if r["annotations"]]
    proto = sum(len({_pcb_pad(r) for r in support[i:i + SUPPORT_CHUNK]})
                for i in range(0, len(support), SUPPORT_CHUNK))
    sizes = {_pcb_pad(r) for r in get_detection_dataset_dicts(
        list(cfg.DATASETS.TEST), filter_empty=False)}
    if len(sizes) != 1:
        raise PhaseError(f"PCB launches: the test set has padded sizes "
                         f"{sorted(sizes)}, one expected")
    return proto, 1


def _pcb_numbers(timing, proto_launches, batch_launches, batches):
    wall = timing["wall_s_per_image"] * timing["images"]
    return dict(prototype_launches=proto_launches,
                launches_per_batch=batch_launches,
                pcb_calls=proto_launches + batch_launches * batches,
                calibration_s=timing["pcb_s"],
                share_of_eval_wall=timing["pcb_s"] / wall)


def _fmt_pcb(d):
    return (f"PCB: {d['prototypes']} prototypes built in "
            f"{d['prototype_s']:.3f} s ({d['prototype_launches']} ROIAlign "
            f"launches), {d['launches_per_batch']} ROIAlign launch(es) a "
            f"batch, {d['calibration_s']:.3f} s in execute_calibration, "
            f"{d['share_of_eval_wall']:.4f} of the evaluation's wall time")


def check_eval_batch(config, weights, dataset, tv_pth, chunks, label,
                     opts=()):
    """Phases 3 and 4 again on one evaluation batch's own inputs, at the
    CLI's batch: NMS at both sites and the ``chunks`` res5 ROIAlign calls
    of the fine-tuned detector (bf16); then a PCB block of the same config
    (``tv_pth`` its ResNet; its prototype build timed and its launches
    counted), its ROIAlign calls on that batch's detections (float32,
    within ROI_F32_TOL, one for each padded size among the images it
    rescores); and that batch's PCB scores, no class excluded, through the
    kernels against those through plain_ops(), float32 with TF32 off and
    deterministic convolutions, within PCB_SCORE_TOL. ``opts`` are merged
    last (phase 20: the text teacher's head).
    Returns PCB's numbers."""
    import numpy as np
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch import cli
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
        build_detection_test_loader,
        device_batches,
        get_detection_dataset_dicts,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation.pcb import (
        PrototypicalCalibrationBlock,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops import (
        plain_ops,
    )

    cfg = get_cfg()
    cfg.merge_from_file(config)
    cfg.merge_from_list(["MODEL.WEIGHTS", weights,
                         "TPU.COMPUTE_DTYPE", "bfloat16",
                         "TEST.PCB_MODELPATH", tv_pth, *EVAL_THRESHOLDS,
                         *opts])
    model = cli.build_test_model(cfg)
    feed = device_batches(build_detection_test_loader(
        cfg, dataset, batch_size=cli.EVAL_BATCH_SIZE, prefetch=False,
        pin_memory=cfg.MODEL.DEVICE == "cuda"), cfg.MODEL.DEVICE)
    images, _, meta = next(feed)
    feed.close()
    with torch.inference_mode():
        calls = capture_kernel_inputs(lambda: model.forward_inference(images))
        det = model.forward_inference(images)
    n = meta["valid_count"]
    fields = {k: getattr(det, k)[:n].cpu().numpy()
              for k in ("boxes", "scores", "classes", "valid")}
    ids, files = meta["image_ids"][:n], meta["file_names"][:n]
    log(f"{label}: kernels on one evaluation batch's own inputs, images "
        f"{tuple(images.image.shape[:3])}, "
        f"{cfg.MODEL.ROI_HEADS.NUM_CLASSES} classes, "
        f"{int(fields['valid'].sum())} detections")
    phase_main_path_inputs(_plain_copies(calls), chunks, label)
    del model, images, calls, det
    torch.cuda.empty_cache()

    proto_launches, _ = pcb_expected_launches(cfg)
    read = _reset_counts()
    pcb = PrototypicalCalibrationBlock(cfg)
    torch.cuda.synchronize()
    built = read()
    if built["roi_align_v2_fwd"] != proto_launches or built[
            "greedy_nms"] or built["roi_align_v2_bwd"]:
        raise PhaseError(f"{label} PCB prototypes: launches {built}, "
                         f"expected {proto_launches} ROIAlign")
    # the padded sizes of the images PCB rescores: those with a detection
    # in its window
    pads = {r["file_name"]: _pcb_pad(r)
            for r in get_detection_dataset_dicts([dataset], False)}
    window = fields["valid"] & (fields["scores"] > cfg.TEST.PCB_LOWER) & (
        fields["scores"] <= cfg.TEST.PCB_UPPER)
    want_launches = len({pads[f] for f, hit in zip(files, window.any(1))
                         if hit})

    def rescore():
        det_np = {k: v.copy() for k, v in fields.items()}
        return pcb.execute_calibration(ids, det_np, file_names=files)[
            "scores"]

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    excluded = pcb.exclude_cls
    try:
        got = {}
        pcalls = capture_kernel_inputs(
            lambda: got.setdefault("main", rescore()))
        # the comparison with no class excluded, so that every detection
        # in the window is rescored (random weights may put them all in
        # excluded base classes)
        pcb.exclude_cls = []
        got["all"] = rescore()
        with plain_ops():
            ref = rescore()
    finally:
        torch.backends.cudnn.deterministic = deterministic
        pcb.exclude_cls = excluded
    pcalls = _plain_copies(pcalls)
    moved = int((got["main"] != fields["scores"]).sum())
    moved_all = int((got["all"] != fields["scores"]).sum())
    err = float(np.abs(got["all"] - ref).max())
    log(f"{label}: PCB on that batch: {moved} scores rescored "
        f"({len(excluded)} classes excluded), {moved_all} with none "
        f"excluded; {len(pcalls['roi_align'])} ROIAlign launches; those "
        f"scores through the kernels vs plain_ops() (float32, TF32 off): "
        f"max abs err {err:.3g} (tol {PCB_SCORE_TOL})")
    if pcalls["nms"] or pcalls["roi_align_bwd"] or len(
            pcalls["roi_align"]) != want_launches:
        raise PhaseError(f"{label} PCB: captured {len(pcalls['nms'])} NMS, "
                         f"{len(pcalls['roi_align'])} ROIAlign and "
                         f"{len(pcalls['roi_align_bwd'])} backward calls; "
                         f"{want_launches} ROIAlign expected")
    if moved_all == 0 or err > PCB_SCORE_TOL:
        raise PhaseError(f"{label} PCB: {moved_all} scores rescored, kernels "
                         f"vs plain ops max abs err {err}")
    roi = [check_roi_align(f"{label}_pcb{i}", args, ROI_F32_TOL)
           for i, args in enumerate(pcalls["roi_align"])]
    return dict(prototypes=len(pcb.prototypes),
                prototype_s=pcb.prototype_seconds,
                batch_launches=len(roi),
                launch_ms=sum(r["ms"] for r in roi) / len(roi),
                launch_graph_ms=sum(r["graph_ms"] for r in roi) / len(roi),
                launch_max_abs_err=max(r["max_abs_err"] for r in roi),
                launch_bound_ms=sum(r["bound_ms"] for r in roi) / len(roi),
                score_err=err, rescored=moved, rescored_none_excluded=moved_all)


# ---------------------------------------------------------------- phase 10
# synthetic COCO at 640x480: 32 trainval images hold every class (three
# boxes an image), the test set is 8 batches of 32, so 3 are timed after
# the evaluator's 5 warm-up batches
COCO_TRAIN_IMAGES = 32
COCO_TEST_IMAGES = 256
COCO_FT_STEPS = 2
COCO_BASE = os.path.join(ROOT, "configs", "coco", "defrcn_det_r101_base.yaml")


def phase_coco(tmp, tv_pth, made=None):
    """COCO at 80 classes through the CLI at full width: a seeded 60-class
    model saved as a detectron2 .pth, randinit surgery 60 -> 80, the gfsod
    1-shot seed-0 config, a fine-tune and the evaluation with PCB; the
    kernels on one COCO evaluation batch's own inputs. ``made``: a
    ``start_coco`` handle already making the COCO under ``tmp``/datasets
    (else it is started here). Returns the launches and the numbers to print."""
    import math
    import shutil

    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch import cli
    from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
        init_weights,
        load_reference_weights,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
        inference_on_dataset,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        build_model,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        model_surgery,
    )

    root = os.path.join(tmp, "datasets")
    made_s, waited = wait_maker(made or start_coco(root),
                                "make_synthetic_coco")
    os.environ["FSODTF_DATASETS"] = root
    log(f"coco: synthetic COCO, {COCO_TRAIN_IMAGES} trainval and "
        f"{COCO_TEST_IMAGES} test images of 640x480, 1-shot seed 0, made "
        f"in {made_s:.1f} s ({waited:.1f} s waited here)")

    # a base model as detectron2 saves one converted from another format:
    # numpy arrays under "model"
    cfg = get_cfg()
    cfg.merge_from_file(COCO_BASE)
    base = build_model(cfg)
    init_weights(base, torch.Generator().manual_seed(0))
    base_dir = os.path.join(tmp, "runs", "coco_base")
    os.makedirs(base_dir)
    base_pth = os.path.join(base_dir, "model_final.pth")
    state = {k: v.numpy() for k, v in base.state_dict().items()}
    torch.save({"model": state, "__author__": "chip_smoke"}, base_pth)
    matched, skipped = load_reference_weights(base_pth, build_model(cfg))
    log(f"coco: a seeded {cfg.MODEL.ROI_HEADS.NUM_CLASSES}-class base model "
        f"as a detectron2 .pth of numpy arrays, read back: {matched} of "
        f"{len(state)} matched, {len(skipped)} unmatched")
    if matched != len(state) or skipped:
        raise PhaseError(f"coco: detectron2 import matched {matched} of "
                         f"{len(state)}: {skipped[:5]}")
    surgery = model_surgery.main([
        "--dataset", "coco", "--method", "randinit", "--src-path", base_pth,
        "--save-dir", base_dir])
    shutil.copytree(os.path.join(ROOT, "configs"),
                    os.path.join(tmp, "configs"))
    _run_script("create_config.py", "--dataset", "coco14", "--config_root",
                os.path.join(tmp, "configs", "coco"), "--shot", "1",
                "--seed", "0", "--setting", "gfsod")
    ft_config = os.path.join(tmp, "configs", "coco",
                             "defrcn_gfsod_r101_novel_1shot_seed0.yaml")

    out = os.path.join(tmp, "runs", "coco_1shot_seed0")
    read = _reset_counts()
    results = cli.main(_workflow_args(
        ft_config, out, "MODEL.WEIGHTS", surgery, "SOLVER.MAX_ITER",
        str(COCO_FT_STEPS), "TEST.PCB_MODELPATH", tv_pth, *EVAL_THRESHOLDS))
    counts = read()
    timing = inference_on_dataset.last_timing
    bbox = results["coco14_test_all"]["bbox"]
    ft_cfg = get_cfg()
    ft_cfg.merge_from_file(ft_config)
    ncls = ft_cfg.MODEL.ROI_HEADS.NUM_CLASSES
    batches = -(-timing["images"] // cli.EVAL_BATCH_SIZE)
    chunks = -(-ft_cfg.MODEL.RPN.POST_NMS_TOPK_TEST // ft_cfg.TPU.ROI_CHUNK)
    # a training step pools its sampled ROIs in chunks too
    step_chunks = -(-ft_cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
                    // ft_cfg.TPU.ROI_CHUNK)
    proto_launches, batch_launches = pcb_expected_launches(ft_cfg)
    want = {"greedy_nms": COCO_FT_STEPS + 2 * batches,
            "roi_align_v2_fwd": step_chunks * COCO_FT_STEPS
            + chunks * batches + proto_launches + batch_launches * batches,
            "roi_align_v2_bwd": step_chunks * COCO_FT_STEPS}
    if counts != want:
        raise PhaseError(f"coco fine-tune + eval: launches {counts}, "
                         f"expected {want}")
    if ncls != 80 or timing["images"] != COCO_TEST_IMAGES or not all(
            math.isfinite(bbox[k]) for k in ("AP", "bAP", "nAP")):
        raise PhaseError(f"coco eval: {ncls} classes, {timing['images']} "
                         f"images, {bbox}")
    nums = _pcb_numbers(timing, proto_launches, batch_launches, batches)
    nums["images_per_s"] = 1 / timing["s_per_image"]
    log(f"coco fine-tune ({COCO_FT_STEPS} steps, {ncls} classes) and "
        f"evaluation of {timing['images']} test images at batch "
        f"{cli.EVAL_BATCH_SIZE}, PCB on: {nums['images_per_s']:.2f} "
        f"images/s over the last {timing['timed_images']}, "
        f"{1 / timing['wall_s_per_image']:.2f} images/s wall; PCB "
        f"{timing['pcb_s']:.3f} s in execute_calibration, "
        f"{nums['share_of_eval_wall']:.4f} of the wall; launches {counts} "
        f"as expected (PCB's ROIAlign: {proto_launches} for the prototypes, "
        f"{batch_launches} a batch, from the dataset dicts); AP "
        f"{bbox['AP']:.4f}, bAP "
        f"{bbox['bAP']:.4f}, nAP {bbox['nAP']:.4f} (seeded weights: "
        f"plumbing, not accuracy)")
    nums.update(check_eval_batch(
        ft_config, os.path.join(out, "model_final.pth"), "coco14_test_all",
        tv_pth, chunks, "coco_eval_path"))
    return counts, nums


def _run_script(name, *argv):
    """Run tools/<name> of the repository in this process."""
    import runpy

    saved = sys.argv
    sys.argv = [name, *argv]
    try:
        runpy.run_path(os.path.join(ROOT, "tools", name),
                       run_name="__main__")
    finally:
        sys.argv = saved


# ---------------------------------------------------------------- phase 11
# the text head of run_text_train_student.sh: a text-guided teacher whose
# LVAttention runs across every ROI of the batch, and the student distilled
# from it (feature L2 and KL at temperature 5)
TEXT_OPTS = ("MODEL.ROI_HEADS.NAME", "TextRes5ROIHeads",
             "MODEL.ROI_HEADS.TEACHER_TRAINING", "False",
             "MODEL.ROI_HEADS.STUDENT_TRAINING", "True",
             "MODEL.ROI_HEADS.DISTILLATE", "True",
             "MODEL.ROI_HEADS.KL", "True", "MODEL.ROI_HEADS.L2", "True",
             "MODEL.ROI_HEADS.KL_TEMP", "5")
# the teacher's base training (run_text_train_teacher.sh)
TEACHER_OPTS = ("MODEL.ROI_HEADS.NAME", "TextRes5ROIHeads",
                "MODEL.ROI_HEADS.TEACHER_TRAINING", "True",
                "MODEL.ROI_HEADS.STUDENT_TRAINING", "False",
                "MODEL.ROI_HEADS.DISTILLATE", "False")
TEXT_LOSSES = {"loss_cls_t", "loss_box_reg_t", "loss_kl",
               "loss_student_feat"}
TEXT_GRADS = ("backbone.res4.0.conv3.weight", "roi_heads.res5.0.conv3.weight",
              "roi_heads.attention.attention.w_q.weight",
              "roi_heads.stu_box_predictor.cls_score.weight")
# the meta-archs that paint GT into the features, each with the head its
# run script gives it (run_voc_distillate_rpn.sh for Distillated)
PAINTING = (
    ("GeneralizedSemanticRCNN", ()),
    ("GeneralizedDistillatedRCNN",
     ("MODEL.ROI_HEADS.NAME", "SematicRes5ROIHeadsCrossOutput",
      "MODEL.ROI_HEADS.OUTPUT_LAYER", "FastRCNNAttentionOutputLayers")),
    ("GeneralizedTextAttRCNN", ()),
)
TEXT_BASE_STEPS = 4
TEXT_FT_STEPS = 2


def time_cross_roi_attention(n, d, reps=5):
    """The teacher's cross-ROI attention at n ROIs of width d, forward and
    backward, CUDA events over ``reps`` after a warm-up: the QK^T, masked
    softmax and AV alone (``scaled_dot_product_attention`` over the n + 1
    keys with the dummy), and the whole LVAttention module; float32, TF32
    as the process has it. Returns ms and the QK^T/AV operation bound."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.models.attention import (
        LVAttention,
        scaled_dot_product_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(1, n, d, device="cuda", generator=gen,
                    requires_grad=True)
    k = torch.randn(1, n + 1, d, device="cuda", generator=gen,
                    requires_grad=True)
    v = torch.randn(1, n + 1, d, device="cuda", generator=gen,
                    requires_grad=True)
    mask = torch.ones(1, n + 1, dtype=torch.bool, device="cuda")
    mask[0, n - 64:n] = False  # a few pad rows

    def sdpa():
        out, _ = scaled_dot_product_attention(q, k, v, d ** 0.5, mask)
        out.sum().backward()

    module = LVAttention(d, torch.randn(15, 300).numpy())
    module.init_params_(torch.Generator().manual_seed(0))
    module.cuda()
    feat = torch.randn(n, d, device="cuda", generator=gen,
                       requires_grad=True)
    labels = torch.randint(0, 16, (n,), device="cuda", generator=gen)
    valid = torch.ones(n, dtype=torch.bool, device="cuda")

    def lv():
        _, out = module(feat, labels, valid)
        out["sim2stext"].sum().backward()

    out = {}
    for name, fn in (("sdpa_ms", sdpa), ("lv_attention_ms", lv)):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / reps
    # QK^T and AV: 2 n (n+1) d multiply-adds each forward, twice that
    # backward; float32 outside the tensor cores
    flops = 3 * 2 * 2 * n * (n + 1) * d
    out["sdpa_bound_ms"] = flops / F32_FLOPS * 1e3
    return out


def phase_painting_archs(tmp, batch=16, infer=8):
    """(d) For each meta-arch that paints GT: one bf16 warm-up step and one
    timed step at ``batch`` (launches NMS 1, ROIAlign forward 2 and backward
    2 a step, finite losses of the first), then one GT-fed
    forward_inference of the
    first ``infer`` images (NMS 2, ROIAlign 4), compared with the same
    forward without GT: it must differ where GT is painted and be equal
    for the Distillated family, which ignores it. Returns the launches of
    all these runs and the numbers."""
    import math

    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        Trainer,
    )

    data = train_batches(13, 1, batch)
    images, gt = (t.to("cuda") for t in data[0])
    sub = lambda t: type(t)(*(x[:infer] for x in vars(t).values()))  # noqa
    total, numbers = {}, {}
    for meta, opts in PAINTING:
        cfg = _train_cfg(os.path.join(tmp, meta), "bfloat16", batch, 2,
                         ("MODEL.META_ARCHITECTURE", meta, *opts))
        trainer = Trainer(cfg, data)
        model = trainer.model
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        read = _reset_counts()
        losses = trainer.train_step(images, gt, 0)
        ms = _timed_steps(lambda k: trainer.train_step(images, gt, 1 + k), 1)
        step_counts = read()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if step_counts != {"greedy_nms": 2, "roi_align_v2_fwd": 4,
                           "roi_align_v2_bwd": 4}:
            raise PhaseError(f"{meta}: 2 train steps launched {step_counts}")
        bad = [k for k, v in losses.items() if not math.isfinite(float(v))]
        if bad:
            raise PhaseError(f"{meta}: non-finite losses {bad}")
        if meta == "GeneralizedDistillatedRCNN" and not {
                "loss_rpn_res2", "loss_rpn_res3", "loss_rpn_res4"} <= set(
                    losses):
            raise PhaseError(f"{meta}: losses {sorted(losses)}")
        model.eval()
        torch.backends.cudnn.deterministic = True
        read = _reset_counts()
        with torch.inference_mode():
            with_gt = model.forward_inference(sub(images), sub(gt))
            without = model.forward_inference(sub(images), None)
        torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = False
        infer_counts = read()
        if infer_counts != {"greedy_nms": 4, "roi_align_v2_fwd": 8,
                            "roi_align_v2_bwd": 0}:
            raise PhaseError(f"{meta}: 2 forwards launched {infer_counts}")
        for det in (with_gt, without):
            if not (torch.isfinite(det.boxes).all()
                    and torch.isfinite(det.scores).all()):
                raise PhaseError(f"{meta}: non-finite detections")
        same = torch.equal(with_gt.scores, without.scores)
        if same != (model.eval_gt_role == "none"):
            raise PhaseError(f"{meta} (eval_gt_role "
                             f"{model.eval_gt_role}): detections with GT "
                             f"{'equal' if same else 'differ from'} those "
                             "without")
        for k in step_counts:
            total[k] = total.get(k, 0) + step_counts[k] + infer_counts[k]
        numbers[meta] = {"step_ms": ms[0], "peak_gib": peak}
        log(f"{meta} ({cfg.MODEL.ROI_HEADS.NAME}, eval_gt_role "
            f"{model.eval_gt_role}): bf16 batch {batch} step {ms[0]:.2f} ms "
            f"(CUDA events, after a warm-up step), peak {peak:.2f} GiB, "
            f"launches over the 2 steps {step_counts}; warm-up losses "
            f"{_fmt(losses)}; GT-fed forward_inference of {infer} and the "
            f"same without GT: launches {infer_counts}, valid detections "
            f"{int(with_gt.valid.sum())} and {int(without.valid.sum())}, "
            f"{'equal' if same else 'different'} scores")
        del trainer, model
        torch.cuda.empty_cache()
    return total, numbers


def phase_text_workflow(tmp, datasets, ft_config, tv_pth):
    """(f) The text recipe through the CLI on phase 9's synthetic VOC:
    teacher base training (DISTILLATE False), randinit 15 -> 20 and
    reset_student surgery, the gfsod 1-shot seed-0 config with the student
    flags (fine-tune), then the evaluation of the test set at the CLI's
    batch with PCB (EVAL_THRESHOLDS). Returns the launches of both CLI runs
    and the numbers."""
    import math

    from fewshotobjectdetection_imporove_via_text_feature_torch import cli
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
        inference_on_dataset,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        model_surgery,
    )

    os.environ["FSODTF_DATASETS"] = datasets
    base_out = os.path.join(tmp, "teacher_base")
    t0 = time.perf_counter()
    read = _reset_counts()
    cli.main(_workflow_args(CONFIG, base_out, "SOLVER.MAX_ITER",
                            str(TEXT_BASE_STEPS), "DATASETS.TEST", "()",
                            *TEACHER_OPTS))
    base_counts = read()
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    step_chunks = -(-cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
                    // cfg.TPU.ROI_CHUNK)
    want = {"greedy_nms": TEXT_BASE_STEPS,
            "roi_align_v2_fwd": step_chunks * TEXT_BASE_STEPS,
            "roi_align_v2_bwd": step_chunks * TEXT_BASE_STEPS}
    if base_counts != want:
        raise PhaseError(f"text teacher training: launches {base_counts}, "
                         f"expected {want}")
    base_s = time.perf_counter() - t0
    wide = model_surgery.main([
        "--dataset", "voc", "--method", "randinit", "--src-path",
        os.path.join(base_out, "model_final.pth"), "--save-dir", base_out])
    cold = model_surgery.main([
        "--dataset", "voc", "--method", "reset_student", "--src-path", wide,
        "--save-dir", base_out, "--seed", "123"])
    ft_out = os.path.join(tmp, "1shot_seed0")
    read = _reset_counts()
    results = cli.main(_workflow_args(
        ft_config, ft_out, "MODEL.WEIGHTS", cold, "SOLVER.MAX_ITER",
        str(TEXT_FT_STEPS), "TEST.PCB_MODELPATH", tv_pth, *EVAL_THRESHOLDS,
        *TEXT_OPTS))
    ft_counts = read()
    timing = inference_on_dataset.last_timing
    bbox = results["voc_2007_test_all1"]["bbox"]
    batches = -(-timing["images"] // cli.EVAL_BATCH_SIZE)
    chunks = -(-cfg.MODEL.RPN.POST_NMS_TOPK_TEST // cfg.TPU.ROI_CHUNK)
    ft_cfg = get_cfg()
    ft_cfg.merge_from_file(ft_config)
    proto, per_batch = pcb_expected_launches(ft_cfg)
    want = {"greedy_nms": TEXT_FT_STEPS + 2 * batches,
            "roi_align_v2_fwd": step_chunks * TEXT_FT_STEPS
            + chunks * batches + proto + per_batch * batches,
            "roi_align_v2_bwd": step_chunks * TEXT_FT_STEPS}
    if ft_counts != want:
        raise PhaseError(f"text student fine-tune + eval: launches "
                         f"{ft_counts}, expected {want}")
    if timing["images"] != WORKFLOW_IMAGES or not all(
            math.isfinite(bbox[k]) for k in ("bAP50", "nAP50")):
        raise PhaseError(f"text workflow eval: {timing['images']} images, "
                         f"{bbox}")
    ips = 1 / timing["s_per_image"]
    log(f"text workflow: teacher base training {TEXT_BASE_STEPS} steps "
        f"({base_s:.1f} s with the model build and loader start), launches "
        f"{base_counts}; randinit then reset_student ({os.path.basename(cold)}"
        f"); student fine-tune {TEXT_FT_STEPS} steps and the evaluation of "
        f"{timing['images']} test images at batch {cli.EVAL_BATCH_SIZE} with "
        f"PCB: {ips:.2f} images/s over the last {timing['timed_images']} "
        f"({1 / timing['wall_s_per_image']:.2f} wall), PCB "
        f"{timing['pcb_s']:.3f} s; launches {ft_counts} as expected; bAP50 "
        f"{bbox['bAP50']:.4f}, nAP50 {bbox['nAP50']:.4f} (seeded weights)")
    return {k: base_counts[k] for k in base_counts}, ft_counts, {
        "eval_images_per_s": ips}


def phase_text(tmp, voc, tv_pth, flagship, profile_dir=None):
    """Phase 11: the text families at full width. (a) float32 batch-2
    text step, kernels vs plain ops; (b) timed bf16 text training at
    IMS_PER_BATCH (and, with --profile, one profiled step split into the
    cross-ROI attention, the rest and the kernels); (c) text serving
    (student) in float32 against the plain ops and timed in bf16; (d) the
    GT-painting meta-archs; (e) the kernels on a text step's own inputs;
    (f) the text workflow through the CLI. ``flagship`` is phase 8 (b)'s
    numbers. Returns {path: launches} and the numbers."""
    import torch

    got = phase_train_f32(tmp, TEXT_OPTS, TEXT_GRADS, "text train f32")
    if not TEXT_LOSSES <= set(got):
        raise PhaseError(f"text train f32: losses {sorted(got)}")
    batch = 16
    n = batch * 512
    text, text_counts, next_step = phase_train_bf16(
        tmp, warmup=2, timed=5, profile_dir=profile_dir, opts=TEXT_OPTS,
        label="text train bfloat16", profile_tag="bf16_text_train_step",
        key_dim=n + 1)
    if not TEXT_LOSSES <= set(text["last_losses"]):
        raise PhaseError(f"text train bf16: losses {text['last_losses']}")
    phase_train_inputs(capture_kernel_inputs(next_step), "text_train_path")
    del next_step
    torch.cuda.empty_cache()
    att = time_cross_roi_attention(n, 2048)
    log(f"text train: the cross-ROI attention at {n} ROIs x 2048, float32 "
        f"(TF32 {'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'})"
        f", forward + backward: QK^T, softmax and AV "
        f"{att['sdpa_ms']:.2f} ms (operation bound {att['sdpa_bound_ms']:.2f}"
        f" ms), the whole LVAttention {att['lv_attention_ms']:.2f} ms")
    serve_counts, calls, chunks, serve = phase_predictor(
        None, TEXT_OPTS, "text predictor")
    del calls
    paint_counts, paint = phase_painting_archs(tmp)
    base_counts, ft_counts, wf = phase_text_workflow(
        os.path.join(tmp, "text_workflow"), voc["datasets"],
        voc["ft_config"], tv_pth)
    split = ""
    if text.get("profile") and flagship.get("profile"):
        t, f = text["profile"], flagship["profile"]
        split = (f"; profiled step device busy {t['busy_ms']:.2f} ms "
                 f"(flagship {f['busy_ms']:.2f}): cross-ROI QK^T/softmax/AV "
                 f"{t['key_dim_ms']:.2f} ms, the rest of the text head "
                 f"{t['busy_ms'] - f['busy_ms'] - t['key_dim_ms']:.2f} ms "
                 f"(the two steps' difference less the attention), the "
                 f"kernels {t['kernels_ms']:.3f} ms")
    log(f"text summary (phase 11 beside phase 8 (b), one card; step ms from "
        f"CUDA events, no synchronize between steps): text train step "
        f"median {text['median_ms']:.2f} ms against the flagship's "
        f"{flagship['median_ms']:.2f} ms (+"
        f"{text['median_ms'] - flagship['median_ms']:.2f}), peak "
        f"{text['peak_gib']:.2f} GiB against {flagship['peak_gib']:.2f}"
        f"{split}; text serving batch-1 requests "
        f"{[round(x, 2) for x in serve['request_ms']]} ms, predict_batch(8) "
        f"{serve['batch8_ms']:.2f} ms; painting meta-archs "
        f"{ {k: {a: round(b, 2) for a, b in v.items()} for k, v in paint.items()} }"
        f"; text workflow evaluation {wf['eval_images_per_s']:.2f} images/s"
        f" with PCB")
    return {"text_training": text_counts, "text_serving": serve_counts,
            "text_painting_archs": paint_counts,
            "text_workflow_teacher": base_counts,
            "text_workflow_student_and_eval": ft_counts}, text


# ---------------------------------------------------------------- phase 12
SERVING_BATCHES = (1, 8)
SERVER_REQUESTS = 24
SERVER_WINDOW_MS = 20.0


def _cfg(dtype, opts=()):
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )

    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(list(opts))
    cfg.MODEL.WEIGHTS = ""  # no checkpoint in the repo: seeded weights
    cfg.TPU.COMPUTE_DTYPE = dtype
    return cfg


def _export_artifact(path, cfg, model, programs_at, label):
    """Export ``model`` at every (batch, shape) of ``programs_at`` and save
    the artifact; logs each export's seconds."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.export import (
        export_program,
        save_serving_artifact,
        serving_meta,
    )

    state = model.state_dict()
    programs, secs = {}, {}
    for b, shape in programs_at:
        t0 = time.perf_counter()
        programs[(b, *shape)] = export_program(model, state, b, shape)
        secs[f"{b}x{shape[0]}x{shape[1]}"] = round(
            time.perf_counter() - t0, 2)
    meta = serving_meta(cfg, sorted({b for b, _ in programs_at}),
                        sorted({tuple(sh) for _, sh in programs_at}), "cuda")
    t0 = time.perf_counter()
    save_serving_artifact(path, meta, programs, state)
    log(f"export {label}: seconds a program {secs}; saved "
        f"{os.path.getsize(path) / 1e6:.1f} MB in "
        f"{time.perf_counter() - t0:.1f} s")
    return secs


def _launches_one_forward(pred, image):
    """The kernels' launches of one batch-1 request."""
    import torch

    read = _reset_counts()
    pred(image)
    torch.cuda.synchronize()
    return read()


def _jpeg(bgr):
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(bgr[:, :, ::-1].copy()).save(buf, format="JPEG",
                                                 quality=95)
    return buf.getvalue()


def _decoded(jpeg):
    """The BGR pixels the server decodes from ``jpeg``."""
    import io

    import numpy as np
    from PIL import Image, ImageOps

    img = ImageOps.exif_transpose(Image.open(io.BytesIO(jpeg)))
    return np.asarray(img.convert("RGB"), np.uint8)[:, :, ::-1]


def _serve(predictor, bodies, max_batch):
    """A DetectionServer on localhost over ``predictor``; every body
    POSTed to /detect at once from its own thread. Returns (responses,
    seconds each, wall seconds)."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.server import (
        DetectionServer,
    )

    server = DetectionServer(predictor, port=0, max_batch=max_batch,
                             batch_window_ms=SERVER_WINDOW_MS).start()
    url = f"http://{server.host}:{server.port}/detect"

    def post(body):
        t0 = time.perf_counter()
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            out = json.loads(r.read())
        return out, time.perf_counter() - t0

    try:
        post(bodies[0])  # warm-up
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as pool:
            done = list(pool.map(post, bodies))
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    outs = [{"boxes": np.asarray(o["boxes"], np.float32).reshape(-1, 4),
             "scores": np.asarray(o["scores"], np.float32),
             "classes": np.asarray(o["classes"], np.int64)}
            for o, _ in done]
    return outs, [t for _, t in done], wall


def _set_match(got, ref, label):
    fracs = [min(_match_fraction(g, r), _match_fraction(r, g))
             for g, r in zip(got, ref)]
    if min(fracs) < MATCH_FRACTION:
        raise PhaseError(f"{label}: detections differ, matched {fracs}")
    return fracs


def phase_serving(tmp, profile_dir=None):
    """Phase 12: the serving entry points on the flagship config at full
    width and depth. With ``profile_dir``, one bf16 predict_batch(8) of the
    artifact is profiled. Returns the launch counts of the exported
    programs' main path and of the HTTP servers, and the numbers."""
    import statistics

    import numpy as np
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        DefaultPredictor,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.export import (
        ServingPredictor,
    )

    images = _synthetic_images(1, 11)
    singles, batch = images[:3], images[3:]
    out = {}
    # float32, TF32 off, deterministic convolutions: the artifact against
    # DefaultPredictor on the same weights, as phase 5 holds the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg32 = _cfg("float32")
    pred32 = DefaultPredictor(cfg32, seed=0)
    bucket = tuple(cfg32.TPU.IMAGE_BUCKETS[-1])
    path32 = os.path.join(tmp, "f32.fsodtf-torch")
    out["export_s_f32"] = _export_artifact(
        path32, cfg32, pred32.model,
        [(b, bucket) for b in SERVING_BATCHES], "float32")
    serving32 = ServingPredictor(path32)
    want = _launches_one_forward(pred32, singles[0])
    got = _launches_one_forward(serving32, singles[0])
    if got != want or not want["greedy_nms"] or not want["roi_align_v2_fwd"]:
        raise PhaseError(f"export: launches of one forward {got}, "
                         f"DefaultPredictor's {want}")
    ref, _, _ = _drive(pred32, singles, batch)
    res, _, _ = _drive(serving32, singles, batch)
    _check_outputs(res, images, cfg32.MODEL.ROI_HEADS.NUM_CLASSES)
    fracs = _set_match(res, ref, "ServingPredictor float32")
    log(f"(b) ServingPredictor float32 vs DefaultPredictor on the same "
        f"weights and images: detections per image "
        f"{[len(o['boxes']) for o in res]} vs {[len(o['boxes']) for o in ref]}"
        f"; matched share (worst way) {[round(f, 4) for f in fracs]}; "
        f"launches of one forward {got} = DefaultPredictor's")

    # (c) the HTTP service, float32: 24 concurrent JPEG requests at the
    # three bucket sizes (every one pads to the 800x1344 bucket at the
    # config's test size), over the artifact with dynamic batching and over
    # DefaultPredictor one request at a time
    sizes = [tuple(b) for b in cfg32.TPU.IMAGE_BUCKETS]
    bodies = [_jpeg(_synthetic_images(100 + k, 1, *sizes[k % 3])[0])
              for k in range(SERVER_REQUESTS)]
    decoded = [_decoded(b) for b in bodies]
    ref = [pred32(im) for im in decoded]
    read = _reset_counts()
    for name, predictor, max_batch in (
            ("ServingPredictor", serving32, max(SERVING_BATCHES)),
            ("DefaultPredictor", pred32, 1)):
        got, secs, wall = _serve(predictor, bodies, max_batch)
        fracs = _set_match(got, ref, f"server over {name}")
        ms = sorted(t * 1e3 for t in secs)
        p99 = ms[min(len(ms) - 1, int(round(0.99 * (len(ms) - 1))))]
        out[f"server_{name}"] = dict(
            requests_per_s=len(bodies) / wall, p50_ms=statistics.median(ms),
            p99_ms=p99, max_batch=max_batch)
        log(f"(c) DetectionServer over {name} (float32, max_batch "
            f"{max_batch}, window {SERVER_WINDOW_MS} ms): {len(bodies)} "
            f"concurrent JPEG requests of {sorted(set(sizes))} in "
            f"{wall:.2f} s, {len(bodies) / wall:.2f} requests/s, p50 "
            f"{statistics.median(ms):.2f} ms, p99 {p99:.2f} ms; every "
            f"response set-matches DefaultPredictor on the decoded image "
            f"(worst {min(fracs):.4f})")
    server_counts = read()
    del serving32, pred32
    torch.cuda.empty_cache()

    # (a), (b) bfloat16, the default COMPUTE_DTYPE: the buckets at batch 1
    # and the largest at batch 8, timed beside DefaultPredictor
    torch.backends.cudnn.deterministic = False
    cfg = _cfg("bfloat16")
    pred = DefaultPredictor(cfg, seed=0)
    path = os.path.join(tmp, "bf16.fsodtf-torch")
    at = [(1, tuple(b)) for b in cfg.TPU.IMAGE_BUCKETS] + [
        (max(SERVING_BATCHES), bucket)]
    out["export_s_bf16"] = _export_artifact(path, cfg, pred.model, at,
                                            "bfloat16")
    serving = ServingPredictor(path)
    for name, p in (("DefaultPredictor", pred), ("ServingPredictor",
                                                 serving)):
        _drive(p, singles[:1], batch)  # warm-up
        read = _reset_counts()
        res, secs, bsec = _drive(p, singles, batch)
        counts = read()
        _check_outputs(res, images, cfg.MODEL.ROI_HEADS.NUM_CLASSES)
        out[name] = dict(request_ms=[x * 1e3 for x in secs],
                         batch8_images_per_s=len(batch) / bsec)
        if name == "ServingPredictor":
            export_counts = counts
        log(f"(b) {name} bfloat16: batch-1 requests "
            f"{[round(x * 1e3, 2) for x in secs]} ms, predict_batch(8) "
            f"{bsec * 1e3:.2f} ms ({len(batch) / bsec:.2f} images/s); "
            f"launches {counts}")
    if profile_dir:
        profile_call("bf16 ServingPredictor predict_batch(8)",
                     lambda: serving.predict_batch(batch), profile_dir,
                     "profile_bf16_serving_batch8.txt")
    del serving, pred
    torch.cuda.empty_cache()
    return export_counts, server_counts, out


def raw_train_batches(seed, n_batches, batch, raw=(384, 512), h=375, w=500,
                      max_size=1333, shorts=(704, 736, 768, 800),
                      max_gt=100, num_classes=15):
    """Raw batches of the device-preprocessing loader: 500x375 images (a
    VOC size) in the (384, 512) source bucket, each with a draw of the
    short side (all landing in the 800x1344 target bucket) and of the
    flip, and 1-20 GT boxes where the device resize puts them. CPU
    tensors; (images, gt, meta)."""
    import numpy as np
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.data.device_preprocess import (
        scale_boxes,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.data.mapper import (
        resize_shortest_edge_size,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
        GTInstances,
        ImageBatch,
    )

    rng = np.random.RandomState(seed)
    images = _synthetic_images(seed, n_batches * batch, h, w)
    out = []
    for k in range(n_batches):
        canvas = np.zeros((batch, *raw, 3), np.uint8)
        boxes = np.zeros((batch, max_gt, 4), np.float32)
        classes = np.zeros((batch, max_gt), np.int32)
        valid = np.zeros((batch, max_gt), bool)
        short = rng.choice(shorts, batch).astype(np.float32)
        flip = rng.rand(batch) < 0.5
        hw = np.zeros((batch, 2), np.int32)
        for i in range(batch):
            canvas[i, :h, :w] = images[k * batch + i]
            hw[i] = resize_shortest_edge_size(h, w, short[i], max_size)
            n = rng.randint(1, 21)
            wh = rng.uniform(16, 250, (n, 2))
            xy = rng.uniform(0, 1, (n, 2)) * ([w, h] - wh)
            boxes[i, :n] = scale_boxes(np.concatenate([xy, xy + wh], 1),
                                       (h, w), hw[i], flip[i])
            classes[i, :n] = rng.randint(0, num_classes, n)
            valid[i, :n] = True
        orig = torch.tensor([[h, w]] * batch, dtype=torch.int32)
        out.append((ImageBatch(torch.from_numpy(canvas),
                               torch.from_numpy(hw), orig),
                    GTInstances(torch.from_numpy(boxes),
                                torch.from_numpy(classes),
                                torch.from_numpy(valid)),
                    {"short": short, "flip": flip, "target_hw": (800, 1344),
                     "max_size": max_size}))
    return out


def phase_device_preprocess(tmp, steps=3):
    """Phase 12 (d): TPU.DEVICE_PREPROCESS. The resize of one raw batch of
    16 on the card against the same call on the CPU, then ``steps`` bf16
    Trainer steps at batch 16 on raw batches, each ended by a CUDA event.
    Returns the run's launches and the numbers."""
    import statistics

    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.data.device_preprocess import (
        device_resize_batch,
        preprocess_batch,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        Trainer,
    )

    batch = _cfg("bfloat16").SOLVER.IMS_PER_BATCH
    data = raw_train_batches(13, 2, batch)
    images, _, meta = data[0]
    args = (images.image, images.orig_hw, torch.from_numpy(meta["flip"]),
            torch.from_numpy(meta["short"]), meta["max_size"],
            meta["target_hw"])
    want, want_hw = device_resize_batch(*args)
    got, got_hw = device_resize_batch(*(a.cuda() if torch.is_tensor(a)
                                        else a for a in args))
    err = float((got.cpu() - want).abs().max())
    if not torch.equal(got_hw.cpu(), want_hw) or not err <= 1e-3 \
            or not torch.equal(want_hw, images.hw):
        raise PhaseError(f"device resize: card vs CPU max abs err {err}, "
                         f"sizes {got_hw.tolist()} vs {want_hw.tolist()}")
    on_card = images.to("cuda")
    ms = time_ms(lambda: preprocess_batch(on_card, meta), 5)
    log(f"(d) device_resize_batch, {batch} raw 500x375 images in a "
        f"(384, 512) source bucket -> 800x1344: card vs CPU max abs err "
        f"{err:.3g} (0-255 scale, tol 1e-3), sizes equal; "
        f"{ms:.3f} ms a batch on the card")

    cfg = _train_cfg(os.path.join(tmp, "dp"), "bfloat16", batch, steps)
    cfg.TPU.DEVICE_PREPROCESS = True
    trainer = Trainer(cfg, data)
    hook, ends, losses = _step_end_hook(trainer)
    trainer.hooks.append(hook)
    torch.cuda.synchronize()
    read = _reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    trainer.train()
    torch.cuda.synchronize()
    counts = read()
    bad = _not_finite(losses)
    if bad:
        raise PhaseError(f"device preprocess: non-finite losses at {bad}")
    if counts != {k: n * steps for k, n in zip(KERNEL_NAMES, (1, 2, 2))}:
        raise PhaseError(f"device preprocess: launches {counts}")
    step_ms = _spacings(start, ends)
    log(f"(d) Trainer with TPU.DEVICE_PREPROCESS, bf16, batch {batch} raw "
        f"500x375 -> 800x1344: step ms (CUDA events) "
        f"{[round(x, 2) for x in step_ms]}, median of the last "
        f"{steps - 1} {statistics.median(step_ms[1:]):.2f}; launches "
        f"{counts}")
    del trainer
    torch.cuda.empty_cache()
    return counts, {"resize_ms": ms, "step_ms": step_ms}


# ---------------------------------------------------------------- phase 13
STANDARD_OPTS = ("MODEL.ROI_HEADS.NAME", "StandardROIHeads",
                 "MODEL.ROI_BOX_HEAD.NUM_FC", "2")
STANDARD_GRADS = ("affine_rcnn.weight", "backbone.res4.0.conv3.weight",
                  "proposal_generator.rpn_head.conv.weight",
                  "roi_heads.box_head.fc1.weight",
                  "roi_heads.cls_head.fc1.weight",
                  "roi_heads.cls_predictor.cls_score.weight",
                  "roi_heads.box_predictor.bbox_pred.weight")


def phase_standard_heads(tmp):
    """Phase 13 (a)-(c) and its serving path: StandardROIHeads on the
    flagship config (two ConvFC towers of NUM_FC 2 over ROIAlign at P 7,
    bin_stride 1 on res4's 1024 channels). Returns the training and
    serving launches, the bf16 step numbers and the bin_stride-1 kernel
    checks."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        DefaultPredictor,
    )

    launches = (1, 1, 1)
    phase_train_f32(tmp, opts=STANDARD_OPTS, grads=STANDARD_GRADS,
                    label="StandardROIHeads f32", launches=launches)
    per_step, counts, next_step = phase_train_bf16(
        tmp, warmup=2, timed=5, opts=STANDARD_OPTS,
        label="StandardROIHeads bf16", launches=launches)
    fwd, bwd = phase_train_inputs(capture_kernel_inputs(next_step),
                                  label="standard_train_path",
                                  launches=launches)
    del next_step
    torch.cuda.empty_cache()

    cfg = _cfg("bfloat16", STANDARD_OPTS)
    pred = DefaultPredictor(cfg, seed=0)
    images = _synthetic_images(1, 10)
    _drive(pred, images[:1], images[2:])  # warm-up
    read = _reset_counts()
    res, secs, bsec = _drive(pred, images[:2], images[2:])
    serve_counts = read()
    _check_outputs(res, images, cfg.MODEL.ROI_HEADS.NUM_CLASSES)
    want = {"greedy_nms": 6, "roi_align_v2_fwd": 3, "roi_align_v2_bwd": 0}
    if serve_counts != want:
        raise PhaseError(f"StandardROIHeads serving: launches "
                         f"{serve_counts}, expected {want}")
    log(f"StandardROIHeads serving, bf16: batch-1 requests "
        f"{[round(x * 1e3, 2) for x in secs]} ms, predict_batch(8) "
        f"{bsec * 1e3:.2f} ms; launches {serve_counts}")
    del pred
    torch.cuda.empty_cache()
    return counts, serve_counts, per_step, {"fwd": fwd[0], "bwd": bwd[0]}


def phase_remat(tmp):
    """Phase 13 (d): one bf16 step at batch 16 with TPU.REMAT_BACKBONE on
    the batch of a step without it, same weights and generators: the
    losses equal, peak memory of each."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        Trainer,
        step_generators,
    )

    cfg = _train_cfg(os.path.join(tmp, "remat"), "bfloat16", 16, 1)
    (images, gt), = train_batches(14, 1, 16)
    trainer = Trainer(cfg, [(images, gt)])
    model = trainer.model
    images, gt = images.to("cuda"), gt.to("cuda")
    runs = {}
    for remat in (False, True):
        model.backbone.remat = remat
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = model.forward_train(
            images, gt, *step_generators(trainer.seed, 0, "cuda"))
        sum(v for k, v in losses.items()
            if not k.startswith("metric/")).backward()
        torch.cuda.synchronize()
        runs[remat] = ({k: float(v.detach()) for k, v in losses.items()},
                       torch.cuda.max_memory_allocated() / 2**30,
                       (time.perf_counter() - t0) * 1e3)
    (l0, m0, t0_ms), (l1, m1, t1_ms) = runs[False], runs[True]
    worst = max(abs(l1[k] - l0[k]) / max(abs(l0[k]), 1e-30) for k in l0)
    if worst > TRAIN_LOSS_RTOL:
        raise PhaseError(f"remat: losses {l1} vs {l0}")
    log(f"(d) TPU.REMAT_BACKBONE, bf16 batch 16, one forward/backward on "
        f"the same batch, weights and generators: losses equal (largest "
        f"relative difference {worst:.3g}); peak memory {m1:.2f} GiB with "
        f"remat, {m0:.2f} GiB without; {t1_ms:.1f} ms against "
        f"{t0_ms:.1f} ms (host clock, one step each)")
    del trainer, model
    torch.cuda.empty_cache()
    return {"peak_gib": m1, "peak_gib_no_remat": m0, "max_rel_loss": worst}


# ---------------------------------------------------------------- phase 14
# NCCL refuses two ranks on one GPU, so on a one-card machine two ranks
# share cuda:0 over gloo (a, b, c, e: host-staged collectives, step times
# not a scaling figure) and NCCL runs at world 1 (d)
P14_RANKS = 2
# (d): the DDP step's timed window, beside phase 8 (b)
P14_WARMUP, P14_TIMED = 2, 5


def _p14_batch():
    """The global batch of (a)-(c): phase 8 (a)'s two images with the
    second cut to a 160x224 image in the 800x1344 canvas (its GT scaled
    in), so the two images sample different numbers of valid ROIs. CPU
    tensors."""
    import torch

    (images, gt), = train_batches(11, 1, 2)
    h, w = 160, 224
    images.image[1, h:] = 0
    images.image[1, :, w:] = 0
    images.hw[1] = torch.tensor([h, w])
    images.orig_hw[1] = torch.tensor([h, w])
    gt.boxes[1] = gt.boxes[1] * torch.tensor([w / 1333, h / 800] * 2)
    return images, gt


def _whole(t):
    """A gradient or parameter as a whole CPU tensor (an FSDP2 shard is
    gathered: every rank calls it)."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.parallel import (
        full_tensor,
    )

    return full_tensor(t).detach().cpu()


def _p14_step(tmp, opts, grads, label, batch):
    """One float32 Trainer step (TF32 off, cuDNN deterministic) on this
    process's rows of ``batch``: one process, or a rank of the process
    group (DDP, or FSDP2 with TPU.MODEL_PARALLEL in ``opts``). Returns the
    global losses, the whole gradients of ``grads``, the sampled ROIs and
    the launches of the step, and the Trainer."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        Trainer,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.parallel import (
        local_rows,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    cfg = _train_cfg(os.path.join(tmp, label.replace(" ", "_")), "float32",
                     2, 1, opts)
    trainer = Trainer(cfg, [batch])
    images, gt = (t.to("cuda") for t in local_rows(batch))
    records, restore = _recording_sampler()
    try:
        read = _reset_counts()
        losses = trainer.train_step(images, gt, 0)
        torch.cuda.synchronize()
        counts = read()
    finally:
        restore()
        torch.backends.cudnn.deterministic = False
    named = dict(trainer.model.named_parameters())
    (_, _, boxes, valid), = records
    return dict(losses={k: float(v) for k, v in losses.items()},
                grads={n: _whole(named[n].grad) for n in grads},
                rois=boxes.cpu(), roi_valid=valid.cpu(),
                counts=counts), trainer


def _p14_bytes(trainer):
    """This rank's parameter and momentum bytes."""
    from torch.distributed.tensor import DTensor

    def local(t):
        t = t.to_local() if isinstance(t, DTensor) else t
        return t.numel() * t.element_size()

    params = sum(local(p) for p in trainer.model.parameters())
    mom = sum(local(st["momentum_buffer"])
              for st in trainer.optimizer.state.values()
              if "momentum_buffer" in st)
    return dict(param_bytes=params, momentum_bytes=mom)


def _p14_rank(spec):
    """Phase 14 in one of the gloo ranks sharing cuda:0: (a) the DDP step,
    (b) the text student step, (c) TPU.MODEL_PARALLEL 2 (FSDP2) with its
    checkpoint gathered to rank 0, then (e) this rank's share of the
    sharded evaluation through the CLI's per-rank body. Returns what the
    parent checks, the launches of each included."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch import cli
    from fewshotobjectdetection_imporove_via_text_feature_torch.data.mapper import (
        DatasetMapper,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
        inference_on_dataset,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.parallel import (
        get_rank,
    )

    out = {"rank": get_rank()}
    batch = _p14_batch()
    tmp = spec["tmp"]
    out["a"], trainer = _p14_step(tmp, (), TRAIN_GRADS, "ddp f32", batch)
    out["a"]["bytes"] = _p14_bytes(trainer)
    del trainer
    out["b"], trainer = _p14_step(tmp, TEXT_OPTS, TEXT_GRADS,
                                  "ddp text f32", batch)
    del trainer
    out["c"], trainer = _p14_step(tmp, ("TPU.MODEL_PARALLEL", "2"),
                                  TRAIN_GRADS, "zero f32", batch)
    out["c"]["bytes"] = _p14_bytes(trainer)
    named = dict(trainer.model.named_parameters())
    out["c"]["params"] = {n: _whole(named[n]) for n in TRAIN_GRADS}
    trainer.save(0, name="zero_step")  # gathered; rank 0 writes
    trainer.checkpointer.wait()
    out["c"]["checkpoint"] = os.path.join(trainer.cfg.OUTPUT_DIR,
                                          "zero_step.pth")
    del trainer, named
    torch.cuda.empty_cache()

    decoded = []
    call = DatasetMapper.__call__

    def recording(self, record, *args, **kwargs):
        decoded.append(record["image_id"])
        return call(self, record, *args, **kwargs)

    DatasetMapper.__call__ = recording
    try:
        read = _reset_counts()
        results = cli.run(cli.default_argument_parser().parse_args(
            spec["eval_argv"]))
        counts = read()
    finally:
        DatasetMapper.__call__ = call
    timing = inference_on_dataset.last_timing
    out["e"] = dict(bbox=results["voc_2007_test_all1"]["bbox"],
                    decoded=sorted(set(decoded)), counts=counts,
                    images=timing["images"],
                    images_per_s=1 / timing["s_per_image"],
                    wall_images_per_s=1 / timing["wall_s_per_image"])
    return out


def _p14_compare(label, got, ref, grads, row=None):
    """``got`` (a rank's step) against ``ref`` within phase 8 (a)'s
    tolerances; with ``row``, the sampled ROIs against that row of
    ``ref``'s. Returns the worst differences."""
    import torch

    if row is not None and not (
            torch.equal(got["rois"], ref["rois"][row:row + 1])
            and torch.equal(got["roi_valid"], ref["roi_valid"][row:row + 1])):
        raise PhaseError(f"{label}: sampled ROIs differ from the "
                         "single-process step's")
    worst = {}
    for k, b in ref["losses"].items():
        if k.startswith("metric/"):
            continue
        a = got["losses"][k]
        worst[k] = abs(a - b) / max(abs(b), 1e-30)
        if worst[k] > TRAIN_LOSS_RTOL:
            raise PhaseError(f"{label}: {k} {a} against {b}")
    for n in grads:
        scale = float(ref["grads"][n].abs().max())
        err = float((got["grads"][n] - ref["grads"][n]).abs().max())
        worst[n] = err / max(scale, 1e-30)
        if not scale > 0 or worst[n] > TRAIN_GRAD_TOL:
            raise PhaseError(f"{label}: gradient of {n} off by "
                             f"{worst[n]:.3g} of its max {scale:.3g}")
    if got["counts"] != dict(zip(KERNEL_NAMES, (1, 2, 2))):
        raise PhaseError(f"{label}: launches {got['counts']}")
    return worst


def _sum_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in KERNEL_NAMES}


def phase_multi_device(tmp, workflow, flagship):
    """Phase 14: multi-device on the port at full width and depth on the
    same config, seeded weights. (a)-(c) and (e) in one spawn of two gloo
    ranks sharing cuda:0 (``engine/launch.py``), against single-process
    references made here first; (d) NCCL at world 1 in this process.
    ``workflow`` is phase 9's numbers, ``flagship`` phase 8 (b)'s. Returns
    {path: launches} and the numbers."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.launch import (
        _free_port,
        launch,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.parallel import (
        destroy_distributed,
        init_distributed,
    )

    t_phase = time.perf_counter()
    batch = _p14_batch()
    ref_a, trainer = _p14_step(tmp, (), TRAIN_GRADS, "one f32", batch)
    ref_a["bytes"] = _p14_bytes(trainer)
    del trainer
    ref_b, trainer = _p14_step(tmp, TEXT_OPTS, TEXT_GRADS, "one text f32",
                               batch)
    del trainer
    torch.cuda.empty_cache()
    os.environ["FSODTF_DATASETS"] = workflow["datasets"]
    eval_argv = ["--eval-only"] + _workflow_args(
        workflow["ft_config"], os.path.join(tmp, "sharded_eval"),
        "MODEL.WEIGHTS", workflow["final"], "TEST.PCB_ENABLE", "False",
        *EVAL_THRESHOLDS)
    t0 = time.perf_counter()
    ranks = launch(_p14_rank, P14_RANKS, args=(dict(
        tmp=tmp, eval_argv=eval_argv),), backend="gloo",
        devices=["cuda:0"] * P14_RANKS, timeout=900)
    spawn_s = time.perf_counter() - t0

    # (a) and (b): each rank against the single-process step
    valid = [int(r["a"]["roi_valid"].sum()) for r in ranks]
    if len(set(valid)) < 2:
        raise PhaseError(f"ddp f32: the ranks sampled {valid} valid ROIs: "
                         "the global normalizers go untested")
    worst_a = [_p14_compare(f"ddp f32 rank {r['rank']}", r["a"], ref_a,
                            TRAIN_GRADS, r["rank"]) for r in ranks]
    worst_b = [_p14_compare(f"ddp text f32 rank {r['rank']}", r["b"], ref_b,
                            TEXT_GRADS, r["rank"]) for r in ranks]
    if not TEXT_LOSSES <= set(ranks[0]["b"]["losses"]):
        raise PhaseError(f"ddp text f32: losses {sorted(ranks[0]['b'])}")
    log(f"multi-device (a): DDP float32 step, global batch 2 on two gloo "
        f"ranks sharing cuda:0 (one image a rank), against one process's "
        f"step on the same batch and generators: sampled ROIs equal, "
        f"valid ROIs by rank {valid} (one process: "
        f"{int(ref_a['roi_valid'].sum())}); worst relative loss and "
        f"gradient differences by rank "
        f"{[_fmt(w) for w in worst_a]}; losses "
        f"{ {k: round(v, 6) for k, v in ranks[0]['a']['losses'].items() if not k.startswith('metric/')} }; "
        f"launches a rank {ranks[0]['a']['counts']}")
    log(f"multi-device (b): DDP text student step (the teacher attends over "
        f"both ranks' ROIs) against one process's: sampled ROIs equal, "
        f"worst differences by rank {[_fmt(w) for w in worst_b]}; launches "
        f"a rank {ranks[0]['b']['counts']}")

    # (c) TPU.MODEL_PARALLEL 2 against (a)'s DP step, checkpoint at world 1
    worst_c = [_p14_compare(f"zero f32 rank {r['rank']}", r["c"], r["a"],
                            TRAIN_GRADS) for r in ranks]
    state = torch.load(ranks[0]["c"]["checkpoint"], map_location="cpu",
                       weights_only=True)
    for n in TRAIN_GRADS:
        if not torch.equal(state["model"][n], ranks[0]["c"]["params"][n]):
            raise PhaseError(f"zero checkpoint: {n} differs from the "
                             "gathered parameter")
    zb = [r["c"]["bytes"] for r in ranks]
    db = ranks[0]["a"]["bytes"]
    log(f"multi-device (c): TPU.MODEL_PARALLEL 2 (FSDP2, mesh (1, 2)) on the "
        f"same two ranks: losses and gradients equal (a)'s DP step (worst "
        f"by rank {[_fmt(w) for w in worst_c]}); parameter and momentum "
        f"bytes by rank {zb} against DP's {db} a rank; its checkpoint, "
        f"gathered to rank 0, loads at world 1 with the gathered values "
        f"({len(state['model'])} tensors); launches a rank "
        f"{ranks[0]['c']['counts']}")
    del state

    # (e) sharded evaluation against phase 9's single-process evaluation
    want = workflow["off_bbox"]
    for r in ranks:
        e = r["e"]
        if {k: e["bbox"][k] for k in ("bAP50", "nAP50")} != {
                k: want[k] for k in ("bAP50", "nAP50")}:
            raise PhaseError(f"sharded eval rank {r['rank']}: {e['bbox']} "
                             f"against one process's {want}")
        if e["images"] != WORKFLOW_IMAGES:
            raise PhaseError(f"sharded eval rank {r['rank']}: "
                             f"{e['images']} images")
    decoded = [set(r["e"]["decoded"]) for r in ranks]
    if decoded[0] & decoded[1] or len(decoded[0] | decoded[1]) != \
            WORKFLOW_IMAGES:
        raise PhaseError(f"sharded eval: decoded {[len(d) for d in decoded]}"
                         f" images, {len(decoded[0] & decoded[1])} by both")
    eval_counts = _sum_counts(*(r["e"]["counts"] for r in ranks))
    if eval_counts != workflow["off_counts"]:
        raise PhaseError(f"sharded eval: launches {eval_counts}, one "
                         f"process {workflow['off_counts']}")
    log(f"multi-device (e): evaluation of {WORKFLOW_IMAGES} test images at "
        f"batch 32 sharded over the two gloo ranks through the CLI (PCB "
        f"off): bAP50 {ranks[0]['e']['bbox']['bAP50']:.4f}, nAP50 "
        f"{ranks[0]['e']['bbox']['nAP50']:.4f} on both ranks, equal to phase "
        f"9's single process; images decoded by rank "
        f"{[len(d) for d in decoded]}; {ranks[0]['e']['images_per_s']:.2f} "
        f"images/s over the last batches ({ranks[0]['e']['wall_images_per_s']:.2f}"
        f" wall) against phase 9's {workflow['off_images_per_s']:.2f} on one "
        f"process; launches by rank {[r['e']['counts'] for r in ranks]}, "
        f"summed equal to phase 9's; the spawn took {spawn_s:.1f} s")

    # (d) NCCL at world 1: the DDP bf16 step at IMS_PER_BATCH, timed
    init_distributed(0, 1, f"tcp://127.0.0.1:{_free_port()}",
                     device="cuda:0")
    try:
        ddp, ddp_counts, next_step = phase_train_bf16(
            tmp, warmup=P14_WARMUP, timed=P14_TIMED,
            label="DDP train bfloat16 (NCCL, world 1)")
        phase_train_inputs(capture_kernel_inputs(next_step),
                           "ddp_train_path")
        del next_step
    finally:
        destroy_distributed()
    torch.cuda.empty_cache()
    log(f"multi-device summary (phase 14; two gloo ranks share the card, "
        f"NCCL only at world 1): DDP bf16 step at batch 16 (NCCL, world 1) "
        f"median {ddp['median_ms']:.2f} ms (mean {ddp['window_ms']:.2f}), "
        f"peak {ddp['peak_gib']:.2f} GiB, beside phase 8 (b)'s "
        f"{flagship['median_ms']:.2f} ms and {flagship['peak_gib']:.2f} GiB;"
        f" sharded evaluation {ranks[0]['e']['images_per_s']:.2f} images/s "
        f"on two gloo ranks of one card (host-staged collectives, not a "
        f"scaling figure); phase 14 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"ddp_training": ddp_counts,
            "ddp_training_gloo_two_ranks": _sum_counts(
                *(r[k]["counts"] for r in ranks for k in ("a", "b"))),
            "zero_training": _sum_counts(*(r["c"]["counts"] for r in ranks)),
            "sharded_eval": eval_counts}, dict(
        ddp=ddp, zero_bytes=zb, dp_bytes=db,
        eval_images_per_s=ranks[0]["e"]["images_per_s"])


# ---------------------------------------------------------------- phase 15
def _overfit(root, argv, label):
    """``overfit_map_check.main(argv)`` on the card, data under ``root``,
    with the launch counters around it. Returns (its result, launches)."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        overfit_map_check,
    )

    torch.cuda.synchronize()
    read = _reset_counts()
    t0 = time.perf_counter()
    res = overfit_map_check.main(argv, root=root)
    torch.cuda.synchronize()
    counts = read()
    log(f"{label} ({' '.join(argv)}): AP50 {res['ap50']:.4f}, recall@0.5 "
        f"{res['hit']}/{res['total']}, PCB "
        f"{res.get('pcb_rescored', '-')} of {res.get('pcb_in_window', '-')} "
        f"in-window scores rescored (recall with PCB "
        f"{res.get('pcb_recall', '-')}), training {res['train_s']:.1f} s, "
        f"step median {res['step_ms_median']:.2f} ms (the Trainer's logged "
        f"20-step windows), peak {res['peak_gib']:.2f} GiB, wall "
        f"{time.perf_counter() - t0:.1f} s; launches {counts}")
    missing = [k for k in KERNEL_NAMES if counts[k] == 0]
    if missing:
        raise PhaseError(f"{label}: no launch of {missing}")
    return res, counts


def _check_next_step(tr, label, **kw):
    """Phases 3, 4 and 7 on the inputs of one more step of ``tr`` on a
    batch of its own loader (``kw``: ``phase_train_inputs``'s)."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
        build_detection_train_loader,
        device_batches,
    )

    loader = build_detection_train_loader(
        tr.cfg, seed=tr.seed, pin_memory=tr.device.type == "cuda")
    feed = device_batches(loader, tr.device)
    try:
        images, gt, meta = next(feed)
    finally:
        feed.close()
        loader.close()
    return phase_train_inputs(capture_kernel_inputs(
        lambda: tr.train_step(images, gt, tr.max_iter, meta)), label, **kw)


def phase_learning(tmp):
    """15. the learning checks: (a) the flagship overfit at full width in
    bf16 with PCB, (b) every kernel on (a)'s own inputs (one more batch-6
    train step, one evaluation batch, PCB on that batch's detections),
    (c) the text head's overfit, and the kernels on one more of its steps.
    An assert of the tools fails the run."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch import cli
    from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
        build_detection_test_loader,
        device_batches,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation.pcb import (
        PrototypicalCalibrationBlock,
    )

    t_phase = time.perf_counter()
    # (a)
    flag, flag_counts = _overfit(os.path.join(tmp, "flagship"),
                                 ["--production", "--pcb"],
                                 "learning (a) flagship overfit")
    tr = flag["trainer"]
    cfg = tr.cfg

    # (b) one more train step on a batch of the loader
    _check_next_step(tr, "learning_train_path")

    # one evaluation batch of the memorized set
    model = tr.model.eval()
    feed = device_batches(build_detection_test_loader(
        cfg, cfg.DATASETS.TEST[0], batch_size=cli.EVAL_BATCH_SIZE,
        prefetch=False, pin_memory=tr.device.type == "cuda"), tr.device)
    try:
        images, _, meta = next(feed)
    finally:
        feed.close()
    with torch.inference_mode():
        calls = capture_kernel_inputs(lambda: model.forward_inference(images))
        det = model.forward_inference(images)
    chunks = -(-cfg.MODEL.RPN.POST_NMS_TOPK_TEST // 256)
    phase_main_path_inputs(_plain_copies(calls), chunks, "learning_eval_path")
    n = meta["valid_count"]
    fields = {k: getattr(det, k)[:n].cpu().numpy()
              for k in ("boxes", "scores", "classes", "valid")}
    pcb = PrototypicalCalibrationBlock(cfg)
    pcalls = capture_kernel_inputs(lambda: pcb.execute_calibration(
        meta["image_ids"][:n], {k: v.copy() for k, v in fields.items()},
        file_names=meta["file_names"][:n]))
    pcalls = _plain_copies(pcalls)
    if pcalls["nms"] or pcalls["roi_align_bwd"] or not pcalls["roi_align"]:
        raise PhaseError(f"learning PCB: captured {len(pcalls['nms'])} NMS, "
                         f"{len(pcalls['roi_align'])} ROIAlign and "
                         f"{len(pcalls['roi_align_bwd'])} backward calls")
    for i, args in enumerate(pcalls["roi_align"]):
        check_roi_align(f"learning_pcb{i}", args, ROI_F32_TOL)
    del model, images, det, calls, pcalls, pcb, tr, flag["trainer"]
    torch.cuda.empty_cache()

    # (c)
    text, text_counts = _overfit(os.path.join(tmp, "text"),
                                 ["--production", "--head",
                                  "TextRes5ROIHeads"],
                                 "learning (c) text-head overfit")
    _check_next_step(text["trainer"], "learning_text_train_path")
    del text["trainer"]
    torch.cuda.empty_cache()
    log(f"learning summary (phase 15): flagship AP50 {flag['ap50']:.4f}, "
        f"recall {flag['recall']:.4f}, PCB {flag['pcb_rescored']}/"
        f"{flag['pcb_in_window']}, step {flag['step_ms_median']:.2f} ms; "
        f"text head AP50 {text['ap50']:.4f}, recall {text['recall']:.4f}, "
        f"step {text['step_ms_median']:.2f} ms; phase 15 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"learning_flagship_pcb": flag_counts,
            "learning_text_head": text_counts}, dict(flagship=flag, text=text)


# ---------------------------------------------------------------- phase 16
SPATIAL_BANDS = (2, 4)
# banded res4 against the whole backbone's, float32 with TF32 off, as a
# share of res4's largest value: the bands sum each convolution in the
# whole image's order unless cuDNN picks another algorithm for a shorter
# band (predicted within 2e-6); a halo slip gives errors of order 1
SPATIAL_RES4_TOL = 1e-4
SPATIAL_TIMED = 10


def _residual_weights(model, seed=16):
    """Seeded weights leave every block's conv3 at zero, which silences the
    residual branch and would hide a slip in the 3x3s' halos: give them
    N(0, (0.2 / sqrt(fan_in))^2), so a block adds about 4% to its
    shortcut's variance."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.backbone.named_parameters():
            if name.endswith("conv3.weight"):
                p.copy_(torch.randn(p.shape, generator=gen)
                        * (0.2 / p[0].numel() ** 0.5))


def _with_bands(pred, cfg, bands):
    """``pred``'s model with its backbone in ``bands`` row bands: through
    ``DefaultPredictor`` on ``cuda:0..bands-1`` where the machine has the
    cards, else every band on the predictor's card (the predictor refuses
    S above the visible cards, so the attribute is set by hand)."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        DefaultPredictor,
    )

    pred.model.spatial_devices = None
    if bands == 1:
        return pred
    if torch.cuda.device_count() >= bands:
        c = cfg.clone()
        c.TPU.SPATIAL_PARTITION = bands
        return DefaultPredictor(c, state_dict=pred.model.state_dict())
    pred.model.spatial_devices = [pred.device] * bands
    return pred


def phase_spatial(card):
    """16. TPU.SPATIAL_PARTITION: one image's R-101 backbone in S row bands
    with a halo exchange before every layer that reads neighbouring rows,
    res4 gathered before the RPN. (a) DefaultPredictor at S above the
    visible cards refuses with the JAX package's ValueError; (b) float32,
    TF32 off, S 2 and 4: banded res4 against the whole backbone's, then one
    request and one predict_batch(4) set-matched against S 1, launches
    counted; (c) bf16, S 1, 2 and 4: request ms (median of 10 after 2
    warm-ups), peak memory, the halo bytes and exchanges of one request,
    the detections' matched share and res4's error against S 1 (reported
    only). Returns the banded runs' launches and the numbers."""
    import statistics

    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        DefaultPredictor,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.predictor import (
        preprocess_single_image,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.parallel.spatial import (
        HALO,
        banded_backbone,
    )

    t_phase = time.perf_counter()
    cfg32, cfg16 = _cfg("float32"), _cfg("bfloat16")
    ncls = cfg32.MODEL.ROI_HEADS.NUM_CLASSES
    chunks = -(-cfg32.MODEL.RPN.POST_NMS_TOPK_TEST // cfg32.TPU.ROI_CHUNK)
    ndev = torch.cuda.device_count()
    out = {"res4_err": {}, "f32_matched": {}, "request_ms": {},
           "peak_gib": {}, "work_gib": {}, "halo": {}, "bf16_matched": {},
           "bf16_res4_err": {}, "refused": []}

    # (a)
    for bands in SPATIAL_BANDS:
        if ndev >= bands:
            continue
        c = cfg32.clone()
        c.TPU.SPATIAL_PARTITION = bands
        try:
            DefaultPredictor(c)
        except ValueError as e:
            if "TPU.SPATIAL_PARTITION" not in str(e):
                raise PhaseError(f"spatial: S {bands} refused with {e}")
            out["refused"].append(str(e))
        else:
            raise PhaseError(f"spatial: DefaultPredictor took S {bands} on "
                             f"{ndev} card(s)")

    # (b) float32, TF32 off, deterministic convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    images = _synthetic_images(16, 5)
    singles, batch = images[:1], images[1:]
    forwards = len(singles) + 1
    want = {"greedy_nms": 2 * forwards,
            "roi_align_v2_fwd": chunks * forwards, "roi_align_v2_bwd": 0}
    total = dict.fromkeys(KERNEL_NAMES, 0)
    pred = DefaultPredictor(cfg32, seed=0)
    _residual_weights(pred.model)
    ref, _, _ = _drive(pred, singles, batch)
    # the whole backbone's run again: how far the unsplit path's own
    # detections move between two runs (ties at the top-100 cut)
    again, _, _ = _drive(pred, singles, batch)
    out["f32_matched"][1] = [min(_match_fraction(g, r),
                                 _match_fraction(r, g))
                             for g, r in zip(again, ref)]

    def res4_err(whole_pred, p):
        """``p``'s banded res4 against ``whole_pred``'s whole backbone on
        the request's image and on the batch's four, as a share of the
        largest value."""
        errs = []
        for ims in (singles, batch):
            x = whole_pred.model.normalize(torch.cat([
                preprocess_single_image(p.cfg, im).image
                for im in ims]).cuda())
            with torch.inference_mode():
                whole = whole_pred.model.backbone(x)["res4"]
                res4 = banded_backbone(p.model.backbone, x,
                                       p.model.spatial_devices)
            errs.append(float((res4.to(whole.device) - whole).abs().max())
                        / float(whole.abs().max()))
        return max(errs)

    for bands in SPATIAL_BANDS:
        p = _with_bands(pred, cfg32, bands)
        err = res4_err(pred, p)
        out["res4_err"][bands] = err
        if not err <= SPATIAL_RES4_TOL:
            raise PhaseError(f"spatial: banded res4 at S {bands} off by "
                             f"{err:.3e} of its largest value")
        read = _reset_counts()
        HALO.reset()
        got, _, _ = _drive(p, singles, batch)
        counts = read()
        if counts != want or HALO.gathers != forwards:
            raise PhaseError(f"spatial S {bands}: launches {counts}, "
                             f"expected {want}; {HALO.gathers} res4 gathers")
        _check_outputs(got, images, ncls)
        out["f32_matched"][bands] = _set_match(got, ref,
                                               f"spatial float32 S {bands}")
        for k in total:
            total[k] += counts[k]
        log(f"spatial float32 S {bands}: res4 error {err:.3e} of its largest"
            f" value; detections {[len(o['boxes']) for o in got]}"
            f" vs S 1 {[len(o['boxes']) for o in ref]}, matched share "
            f"{[round(f, 4) for f in out['f32_matched'][bands]]}; launches "
            f"{counts}")
    torch.backends.cudnn.deterministic = False
    state = pred.model.state_dict()
    del pred, p
    torch.cuda.empty_cache()

    # (c) bfloat16, the default COMPUTE_DTYPE: the timed requests
    pred = DefaultPredictor(cfg16, state_dict=state)
    del state
    image = images[0]
    for bands in (1, *SPATIAL_BANDS):
        p = _with_bands(pred, cfg16, bands)
        for _ in range(2):
            p(image)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        read = _reset_counts()
        secs = []
        for _ in range(SPATIAL_TIMED):
            t0 = time.perf_counter()
            got = p(image)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        counts = read()
        out["peak_gib"][bands] = torch.cuda.max_memory_allocated() / 2**30
        out["work_gib"][bands] = out["peak_gib"][bands] - resident / 2**30
        out["request_ms"][bands] = statistics.median(secs) * 1e3
        _check_outputs([got], [image], ncls)
        if counts != {k: v * SPATIAL_TIMED // forwards
                      for k, v in want.items()}:
            raise PhaseError(f"spatial bf16 S {bands}: launches {counts}")
        if bands == 1:
            # bf16's own spread: the same image at batch 2 (another cuDNN
            # algorithm) against batch 1
            base = got
            twice = p.predict_batch([image, image])[0]
            out["bf16_matched"][1] = min(_match_fraction(twice, base),
                                         _match_fraction(base, twice))
            continue
        for k in total:
            total[k] += counts[k]
        HALO.reset()
        p(image)
        out["halo"][bands] = dict(bytes=HALO.bytes, rows=HALO.rows,
                                  exchanges=HALO.exchanges,
                                  halo_layers=HALO.halo_layers)
        out["bf16_matched"][bands] = min(_match_fraction(got, base),
                                         _match_fraction(base, got))
        out["bf16_res4_err"][bands] = res4_err(pred, p)
    pred.model.spatial_devices = None
    del pred, p
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"spatial partition summary (phase 16; {card}): {ndev} card(s), "
        f"refused {out['refused']}; float32 res4 error "
        f"{ {k: f'{v:.3e}' for k, v in out['res4_err'].items()} } of its "
        f"largest value; bf16 request ms (median of {SPATIAL_TIMED}) "
        f"{ {k: round(v, 2) for k, v in out['request_ms'].items()} }, peak "
        f"GiB on cuda:0 "
        f"{ {k: round(v, 3) for k, v in out['peak_gib'].items()} } (above "
        f"the resident weights "
        f"{ {k: round(v, 3) for k, v in out['work_gib'].items()} }), "
        f"halo a request {out['halo']}, float32 detections matched against "
        f"S 1 (S 1: a second run) "
        f"{ {k: min(v) for k, v in out['f32_matched'].items()} }"
        f", bf16 (S 1: batch 2 against batch 1) "
        f"{ {k: round(v, 4) for k, v in out['bf16_matched'].items()} } "
        f"(res4 error "
        f"{ {k: f'{v:.3e}' for k, v in out['bf16_res4_err'].items()} }); "
        f"launches {total}; phase 16 took {out['seconds']:.1f} s")
    return total, out


# ---------------------------------------------------------------- phase 17
GATE_SCRIPT = os.path.join(
    ROOT, "fewshotobjectdetection_imporove_via_text_feature_torch", "tools",
    "check_generalization.sh")
GATE_LEGS = "base,control,ft,stats"
# the tiny profile's width options, dropped for (b)'s full-width step
GATE_WIDTH_KEYS = ("MODEL.RESNETS.DEPTH", "MODEL.RESNETS.STEM_OUT_CHANNELS",
                   "MODEL.RESNETS.RES2_OUT_CHANNELS",
                   "MODEL.RESNETS.WIDTH_PER_GROUP")
# the base leg's solver options (check_generalization.sh, base leg)
GATE_BASE_OPTS = ("MODEL.WEIGHTS", "", "SOLVER.MAX_ITER", "1200",
                  "SOLVER.STEPS", "(900,1080)", "SOLVER.BASE_LR", "0.01",
                  "SOLVER.WARMUP_ITERS", "100")


def _gate_default(name):
    """A knob's default in the gate script (``NAME=${NAME:-N}``)."""
    import re

    with open(GATE_SCRIPT) as f:
        return int(re.search(rf"^{name}=\$\{{{name}:-(\d+)\}}", f.read(),
                             re.M).group(1))


def _gate_metric(log_path, index):
    """The script's own scrape: a field of the last copypaste row."""
    rows = [ln for ln in open(log_path) if "copypaste:" in ln and "," in ln]
    return float(rows[-1].split("copypaste:")[-1].strip().split(",")[index])


def _run_gate(save_dir, counts_file):
    """(a) The script as a subprocess on the card; its stdout streamed to
    ``save_dir``.log with each line's arrival time. Returns (wall seconds
    by leg, total seconds)."""
    env = dict(os.environ, DEVICE="cuda", GEN_LEGS=GATE_LEGS,
               FSODTF_LAUNCH_COUNTS=counts_file)
    leg_starts, t0 = [], time.perf_counter()
    with open(save_dir + ".log", "w") as out:
        proc = subprocess.Popen(["bash", GATE_SCRIPT, save_dir], cwd=ROOT,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            out.write(line)
            if line.startswith("=== "):
                leg_starts.append((line.strip("= \n"),
                                   time.perf_counter()))
        rc = proc.wait()
    total = time.perf_counter() - t0
    with open(save_dir + ".log") as f:
        text = f.read()
    if rc != 0 or "PAIRED STATS OK" not in text or \
            "GENERALIZATION GATE PASSED" not in text:
        raise PhaseError(f"generalization gate: exit {rc}; last output:\n"
                         f"{text[-3000:]}")
    ends = [t for _, t in leg_starts[1:]] + [t0 + total]
    return {name: end - start
            for (name, start), end in zip(leg_starts, ends)}, total


def phase_generalization(tmp, card):
    """17. (a) the VOC gate's flagship chain on the card with its floors,
    (b) the kernels on the gate's own step inputs, tiny and at full width,
    (c) the PCB extractor trained and loaded. Returns ({path: launches},
    numbers)."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
        load_torch_state,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
        register_all,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        Trainer,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation.archs import (
        torchvision_r101_manifest,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation.pcb import (
        PrototypicalCalibrationBlock,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        card_vs_cpu,
        train_pcb_extractor,
    )

    t_phase = time.perf_counter()
    out = {}
    # (a) the counts of the CLI processes, each appended at its exit: the
    # file starts empty just before the run, and is read just after
    save = os.path.join(tmp, "gate")
    counts_file = os.path.join(tmp, "gate_launches.jsonl")
    open(counts_file, "w").close()
    legs, total_s = _run_gate(save, counts_file)
    runs = [json.loads(ln) for ln in open(counts_file) if ln.strip()]
    counts = {k: sum(r[k] for r in runs) for k in KERNEL_NAMES}
    out["legs_s"], out["gate_s"] = legs, total_s
    base_log = os.path.join(save, "base1.log")
    ft_log = os.path.join(save, "10shot_seed0.log")
    ctrl_log = os.path.join(save, "control.log")
    out["base_ap50"] = _gate_metric(base_log, 1)
    out["control_nap50"] = _gate_metric(ctrl_log, 7)
    out["ft_bap50"] = _gate_metric(ft_log, 4)
    out["ft_nap50"] = _gate_metric(ft_log, 7)
    out["drop"] = out["base_ap50"] - out["ft_bap50"]
    out["gain"] = out["ft_nap50"] - out["control_nap50"]
    # the launches the CLI runs owe: one NMS and one 256-ROI chunk forward
    # and backward a training step (8 images x 32 ROIs), two NMS and one
    # chunk an evaluation batch of 32
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(card_vs_cpu.gate_tiny_opts("cuda", 5))
    steps = _gate_default("ITERS_BASE") + _gate_default("ITERS_FT")
    evals = sum(open(p).read().count("copypaste: Task: bbox")
                for p in (base_log, ctrl_log, ft_log))
    with open(os.path.join(save, "datasets", "VOC2007", "ImageSets",
                           "Main", "test.txt")) as f:
        test_images = len([ln for ln in f if ln.strip()])
    from fewshotobjectdetection_imporove_via_text_feature_torch import cli

    batches = evals * -(-test_images // cli.EVAL_BATCH_SIZE)
    step_chunks = -(-cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
                    // cfg.TPU.ROI_CHUNK)
    eval_chunks = -(-cfg.MODEL.RPN.POST_NMS_TOPK_TEST // cfg.TPU.ROI_CHUNK)
    want = {"greedy_nms": steps + 2 * batches,
            "roi_align_v2_fwd": step_chunks * steps + eval_chunks * batches,
            "roi_align_v2_bwd": step_chunks * steps}
    if len(runs) != 3 or counts != want:
        raise PhaseError(f"generalization gate: {len(runs)} CLI processes "
                         f"reported launches {counts}, expected {want} "
                         f"({steps} steps, {batches} evaluation batches)")
    log(f"generalization (a) gate legs {GATE_LEGS} ({card}): base AP50 "
        f"{out['base_ap50']:.2f} (floor 60), control nAP50 "
        f"{out['control_nap50']:.2f}, ft bAP50 {out['ft_bap50']:.2f} "
        f"(floor 70) / nAP50 {out['ft_nap50']:.2f} (floor 30), drop "
        f"{out['drop']:.2f} (margin 12), gain {out['gain']:.2f} (margin "
        f"20); wall by leg "
        f"{ {k: round(v, 1) for k, v in legs.items()} } s, {total_s:.1f} s "
        f"in all; launches {counts} as expected")

    # (b) one step of the gate's base config on the gate's data, at the tiny
    # profile and at full R-101 width, float32
    datasets = os.path.join(save, "datasets")
    os.environ["FSODTF_DATASETS"] = datasets
    register_all(datasets)
    tiny = card_vs_cpu.gate_tiny_opts("cuda", 5)
    pairs = list(zip(tiny[0::2], tiny[1::2]))
    wide = [x for k, v in pairs if k not in GATE_WIDTH_KEYS for x in (k, v)]
    out["steps"] = {}
    for label, opts in (("tiny", tiny), ("full_width", wide)):
        cfg = get_cfg()
        cfg.merge_from_file(CONFIG)
        cfg.merge_from_list([*opts, *GATE_BASE_OPTS, "OUTPUT_DIR",
                             os.path.join(tmp, f"step_{label}")])
        tr = Trainer(cfg)
        fwd, bwd = _check_next_step(tr, f"generalization_{label}_step",
                                    launches=(1, 1, 1), fwd_tol=ROI_F32_TOL)
        out["steps"][label] = dict(
            depth=cfg.MODEL.RESNETS.DEPTH,
            fwd_err=fwd[0]["max_abs_err"], bwd_err=bwd[0]["max_abs_err"])
        del tr
        torch.cuda.empty_cache()
    log(f"generalization (b) kernels on the gate step's own inputs: "
        f"{out['steps']}")

    # (c) the extractor at its defaults on the gate's data (the tool exits
    # when its accuracy is under its --acc-floor, 0.7), then loaded
    pth = os.path.join(tmp, "pcb_extractor.pth")
    try:
        ext = train_pcb_extractor.main(["--data-root", datasets,
                                        "--out", pth])
    except SystemExit as e:
        raise PhaseError(f"PCB extractor: {e}") from e
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(
        save, "cfgs", "voc", "defrcn_gfsod_r101_novel1_10shot_seed0.yaml"))
    cfg.merge_from_list([*tiny, "TEST.PCB_MODELPATH", pth])
    t0 = time.perf_counter()
    pcb = PrototypicalCalibrationBlock(cfg)
    pcb_s = time.perf_counter() - t0
    saved = load_torch_state(pth)
    loaded = pcb.model.state_dict()
    matched = sum(torch.equal(loaded[k].cpu(), torch.as_tensor(v))
                  for k, v in saved.items() if k in loaded)
    if matched != len(torchvision_r101_manifest()) or \
            len(saved) != matched:
        raise PhaseError(f"PCB loaded {matched} of {len(saved)} tensors")
    out["extractor"] = dict(ext, pcb_init_s=pcb_s, matched=matched)
    del pcb
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"generalization summary (phase 17; {card}): gate base AP50 "
        f"{out['base_ap50']:.2f}, control nAP50 {out['control_nap50']:.2f},"
        f" ft bAP50 {out['ft_bap50']:.2f} / nAP50 {out['ft_nap50']:.2f}, "
        f"drop {out['drop']:.2f}, gain {out['gain']:.2f}, gate "
        f"{total_s:.1f} s; PCB extractor {ext['crops']} crops, final "
        f"accuracy {ext['final_acc']:.3f}, loss {ext['first_loss']:.4f} -> "
        f"{ext['last_loss']:.4f}, {ext['iters']} steps in "
        f"{ext['train_s']:.1f} s, PCB built with it in {pcb_s:.1f} s, "
        f"{matched} tensors matched; phase 17 took {out['seconds']:.1f} s")
    return {"generalization_gate": counts}, out


# ----------------------------------------------------------------- phase 18
# the gate's clean fine-tune, card against CPU, float32 with TF32 off: the
# training step's criteria (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL) at step 0.
# Later steps agree to ~1e-7 until a near-tie (an NMS score, an IoU at a
# threshold) falls the other way on one device and one sampled ROI changes:
# on an H100 that moved a step's loss by 6.7e-4 and the gap stayed near
# 1e-4 after it; a wrong draw or dropout mask moves the cls loss by
# percents, so the trajectories must stay within 1e-2 and every step must
# sample as many ROIs and anchors on both devices. Strict bAP of one
# checkpoint on both devices within 0.3
CARD_CPU_STEPS = 20
CARD_CPU_TRAJ_RTOL = 1e-2
CARD_CPU_BAP_TOL = 0.3
CARD_CPU_COUNTS = ("metric/rpn_num_pos_anchors", "metric/rpn_num_neg_anchors",
                   "metric/roi_num_fg_samples", "metric/roi_num_bg_samples")


def phase_card_vs_cpu(tmp, card):
    """18. The gate's clean fine-tune (phase 17's surgered checkpoint, its
    data, the ft leg's config) on the card against the CPU, through
    ``…_torch/tools/card_vs_cpu.py``: (a) step 0 from one checkpoint on one
    decoded batch with host-drawn sampling and dropout; (b) 20 steps in
    lockstep, the losses printed, the sample counts equal; (c) phase 17's
    fine-tuned checkpoint evaluated on both devices; (d) the Trainer's
    float32 steps twice on the card over the same batches, bitwise equal.
    Returns ({path: launches}, numbers)."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        card_vs_cpu,
    )

    t0 = time.perf_counter()
    save = os.path.join(tmp, "gate")
    datasets = os.path.join(save, "datasets")
    base = os.path.join(save, "base1", "model_reset_surgery.pth")
    ft = os.path.join(save, "10shot_seed0", "model_final.pth")
    counts = _reset_counts()
    res = card_vs_cpu.lockstep(base, datasets, CARD_CPU_STEPS,
                               out_dir=os.path.join(tmp, "card_vs_cpu"))
    launches = counts()
    first = res["first_step"]
    log(f"card vs CPU (a) step 0 of the clean fine-tune: losses within "
        f"{first['loss_rel']:.3e} relative (limit {TRAIN_LOSS_RTOL}), "
        f"gradients within {first['grad_err']:.3e} of their largest value "
        f"{first['grad_max']:.3e} (limit {TRAIN_GRAD_TOL}; worst "
        f"{first['grad_worst']})")
    if first["loss_rel"] > TRAIN_LOSS_RTOL or \
            first["grad_err"] > TRAIN_GRAD_TOL:
        raise PhaseError(f"card vs CPU: step 0 differs: {first}")
    for r in res["steps"]:
        log(f"  step {r['step']}: total loss card "
            f"{r['card']['total_loss']:.8f} CPU {r['cpu']['total_loss']:.8f}"
            f" (relative gap {r['total_rel']:.3e})")
    worst = max(res["steps"], key=lambda r: r["total_rel"])
    groups = ", ".join(f"{g} {v['gap']:.3e} of {v['moved']:.3e}" for g, v
                       in res["steps"][-1]["groups"].items())
    log(f"card vs CPU (b) {CARD_CPU_STEPS} steps: largest relative gap "
        f"{res['max_total_rel']:.3e} at step {worst['step']} (limit "
        f"{CARD_CPU_TRAJ_RTOL}); at the last step each group's distance "
        f"between the devices against its movement: {groups}")
    if res["max_total_rel"] > CARD_CPU_TRAJ_RTOL:
        raise PhaseError(f"card vs CPU: the trajectories part at step "
                         f"{worst['step']}: {worst}")
    unequal = [r["step"] for r in res["steps"]
               if any(r["card"][k] != r["cpu"][k] for k in CARD_CPU_COUNTS)]
    if unequal:
        raise PhaseError(f"card vs CPU: the sample counts differ at steps "
                         f"{unequal}")
    # (d) the Trainer's float32 steps on the card (exact_float32) twice
    # over the same batches: bitwise equal
    rep = card_vs_cpu.card_repeat(base, datasets, CARD_CPU_STEPS,
                                  out_dir=os.path.join(tmp, "card_repeat"))
    launches = counts()
    log(f"card vs CPU (d) two card runs of {CARD_CPU_STEPS} float32 steps "
        f"from one checkpoint: losses bitwise equal {rep['losses_equal']}, "
        f"parameters bitwise equal {rep['params_equal']}")
    if not (rep["losses_equal"] and rep["params_equal"]):
        raise PhaseError(f"card vs CPU: the card's float32 steps are not "
                         f"reproducible: {rep}")
    # a step: one NMS, one forward and backward per ROI chunk (8 x 32 ROIs)
    cfg = card_vs_cpu.gate_cfg(base)
    step_chunks = -(-cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
                    // cfg.TPU.ROI_CHUNK)
    steps = 3 * CARD_CPU_STEPS
    want = {"greedy_nms": steps, "roi_align_v2_fwd": step_chunks * steps,
            "roi_align_v2_bwd": step_chunks * steps}
    if launches != want:
        raise PhaseError(f"card vs CPU: launches {launches}, expected "
                         f"{want} ({steps} steps)")
    counts = _reset_counts()
    ev = {dev: card_vs_cpu.evaluate(ft, datasets, dev,
                                    os.path.join(tmp, f"card_vs_cpu_{dev}"))
          for dev in ("cuda", "cpu")}
    eval_launches = counts()
    with open(os.path.join(datasets, "VOC2007", "ImageSets", "Main",
                           "test.txt")) as f:
        test_images = len([ln for ln in f if ln.strip()])
    from fewshotobjectdetection_imporove_via_text_feature_torch import cli

    batches = -(-test_images // cli.EVAL_BATCH_SIZE)
    eval_chunks = -(-cfg.MODEL.RPN.POST_NMS_TOPK_TEST // cfg.TPU.ROI_CHUNK)
    want = {"greedy_nms": 2 * batches,
            "roi_align_v2_fwd": eval_chunks * batches, "roi_align_v2_bwd": 0}
    if eval_launches != want:
        raise PhaseError(f"card vs CPU: evaluation launches {eval_launches},"
                         f" expected {want} ({batches} batches)")
    launches = {k: launches[k] + eval_launches[k] for k in KERNEL_NAMES}
    gap = abs(ev["cuda"]["bAP"] - ev["cpu"]["bAP"])
    log(f"card vs CPU (c) phase 17's fine-tuned checkpoint: strict bAP "
        f"{ev['cuda']['bAP']:.4f} on the card, {ev['cpu']['bAP']:.4f} on "
        f"the CPU (gap {gap:.4f}, limit {CARD_CPU_BAP_TOL}); bAP50 "
        f"{ev['cuda']['bAP50']:.4f} / {ev['cpu']['bAP50']:.4f}")
    if not gap <= CARD_CPU_BAP_TOL:
        raise PhaseError(f"card vs CPU: evaluation differs: {ev}")
    secs = time.perf_counter() - t0
    log(f"card vs CPU summary (phase 18; {card}): step 0 losses "
        f"{first['loss_rel']:.3e}, gradients {first['grad_err']:.3e}; "
        f"{CARD_CPU_STEPS} steps' largest gap {res['max_total_rel']:.3e}; "
        f"strict bAP gap {gap:.4f}; two card runs bitwise equal; "
        f"launches {launches}; {secs:.1f} s")
    return {"card_vs_cpu_finetune": launches}, dict(
        first=first, max_total_rel=res["max_total_rel"], bap=ev,
        seconds=secs)


# ----------------------------------------------------------------- phase 19
# the default compute dtype on the card against the CPU, by the rule and on
# the cases of tools/bf16_parity.py (the tests/test_torch_bf16_*.py cases,
# there against the JAX package), the card in the place of X: C is the
# port in bfloat16 on the card, T' the port in bfloat16 on the CPU and R'
# the port in float32 on the CPU, on the same inputs and weights:
#   rule 1, per tensor: e(C) <= 2 e(T') + u;
#   rule 2, proposals and detections from the same bf16-rounded head
#     outputs: the same sets on the card as on the CPU;
#   rule 3, of the valid detections: C matches (IoU > 0.9, same class) at
#     least as many in T' as T' matches in R'
# (b): one image and one training step at the 512x864 bucket, full R-101
# width, on a batch of BF16_FULL_BATCH; the nine gradients of
# tests/test_torch_train_model.py
BF16_FULL_BATCH = 1
BF16_FULL_HW = (512, 864)
BF16_GRADS = ("affine_rpn.weight", "affine_rcnn.weight",
              "proposal_generator.rpn_head.conv.weight",
              "backbone.stem.conv1.weight", "backbone.res3.0.conv1.weight",
              "backbone.res4.0.conv2.weight", "roi_heads.res5.0.conv3.weight",
              "roi_heads.box_predictor.cls_score.weight",
              "roi_heads.box_predictor.bbox_pred.weight")
# (b)'s output layers are drawn around the image's own features
# (_bf16_full_state): the RPN's objectness and deltas and the box deltas
# spread by BF16_HEAD_STD, the classifier so that BF16_CONFIDENT_SHARE of
# the proposals score above BF16_CONFIDENT, which makes its confident
# detections the valid ones (SCORE_THRESH_TEST)
BF16_HEAD_STD = 0.5
BF16_CONFIDENT = 0.5
BF16_CONFIDENT_SHARE = 0.1


class _Rule4:
    """Rule 4's comparisons, each with its two sides; every failure is
    kept, and the phase fails after all were made and printed."""

    def __init__(self):
        self.rows, self.failed = [], []

    def tensors(self, case, name, c, t, r):
        """Rule 1 on one tensor of each arm."""
        import numpy as np
        from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
            bf16_parity,
        )

        if not np.abs(r).max() > 0:
            self.failed.append(f"{case} {name}: R' is zero (no teeth)")
            return
        ec, et, limit = bf16_parity.rule1(c, t, r)
        self.rows.append(dict(case=case, name=name, rule=1, e_card=ec,
                              e_cpu_bf16=et, limit=limit))
        if not ec <= limit:
            self.failed.append(f"{case} {name}: e(C) {ec:.4e} > 2 e(T') + u"
                               f" = {limit:.4e}")

    def detections(self, case, c, t, r, held=True):
        """Rule 3 on [(boxes, classes)] per image of each arm; a comparison
        not ``held`` is recorded and fails nothing."""
        from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
            bf16_parity,
        )

        ct, tr, n = bf16_parity.rule3(c, t, r)
        n = dict(zip(("C", "T'", "R'"), n.values()))
        self.rows.append(dict(case=case, name="detections", rule=3,
                              card_in_cpu_bf16=ct, cpu_bf16_in_f32=tr,
                              valid=n, held=held))
        if not held:
            return
        if min(n.values()) <= 10:
            self.failed.append(f"{case}: valid detections {n} (no teeth)")
        elif ct < tr:
            self.failed.append(f"{case}: C matches {ct} in T', T' matches "
                               f"{tr} in R'")

    def same(self, case, ok, detail):
        """Rule 2: a set computed on both devices from the same inputs."""
        self.rows.append(dict(case=case, name=detail, rule=2, equal=ok))
        if not ok:
            self.failed.append(f"{case}: {detail} differ")

    def summary(self, rows=None):
        """One line over ``rows`` (every comparison made so far)."""
        rows = self.rows if rows is None else rows
        ones = [r for r in rows if r["rule"] == 1]
        worst = max(ones, key=lambda r: r["e_card"] / r["limit"],
                    default=None)
        threes = [r for r in rows if r["rule"] == 3]
        twos = [r for r in rows if r["rule"] == 2]
        out = f"{len(ones)} tensors"
        if worst:
            out += (f" (worst e(C)/limit {worst['e_card'] / worst['limit']:.3f}"
                    f": {worst['case']} {worst['name']}, e(C) "
                    f"{worst['e_card']:.4e}, e(T') {worst['e_cpu_bf16']:.4e})")
        out += f"; {len(twos)} same-input sets, equal " \
               f"{sum(r['equal'] for r in twos)}"
        out += "; detections (C in T' / T' in R' of valid): " + ", ".join(
            f"{r['case']} {r['card_in_cpu_bf16']}/{r['cpu_bf16_in_f32']} of "
            f"{r['valid']}" + ("" if r["held"] else " (reported)")
            for r in threes)
        return out


def _bf16_dets(det):
    """Detections -> [(boxes, classes)] of each image's valid rows."""
    out = []
    for i in range(det.valid.shape[0]):
        v = det.valid[i].cpu().numpy()
        out.append((det.boxes[i].float().cpu().numpy()[v],
                    det.classes[i].cpu().numpy()[v]))
    return out


def _np(t):
    return t.detach().float().cpu().numpy()


def _bf16_tiny_states():
    """Every (a) model's float32 state, seeded and perturbed, made once."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        GeneralizedRCNN,
        build_model,
        text_heads,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        bf16_parity as cases,
    )

    seed = cases.seed_weights
    states = {
        "flagship": seed(GeneralizedRCNN(**cases.tiny_kwargs())),
        "standard": seed(GeneralizedRCNN(**cases.tiny_kwargs(
            roi_heads_name="StandardROIHeads", box_convfc=(1, 32, 2, 64)))),
        "predictor": seed(build_model(cases.predictor_cfg("float32"))),
        "export": seed(build_model(cases.export_cfg("float32"))),
    }
    for meta in cases.TEXT_ARCHS:
        cls, extra = text_heads.META_ARCHS[meta]
        states[meta] = seed(cls(**extra, **cases.text_kwargs(meta)))
    return states


def _bf16_tiny_arm(device, dtype, states, shared, tmp):
    """(a) on one arm: every case of the CPU tests, the port alone on
    ``device`` in ``dtype``. ``shared`` carries T''s bf16 res4 and RPN head
    outputs (the inputs the later arms are fed), filled by the first arm.
    Returns {(kind, case, name): value}: kind "t" a tensor (numpy), "d"
    detections."""
    import numpy as np
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.data.device_preprocess import (
        preprocess_batch,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        DefaultPredictor,
        make_train_step,
        step_generators,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.export import (
        ServingPredictor,
        export_inference,
        save_serving_artifact,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        GeneralizedRCNN,
        text_heads,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.solver import (
        build_gradient_clipper,
        build_optimizer,
        build_scheduler,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        bf16_parity as cases,
    )

    dev = torch.device(device)
    out = {}

    def model(state, cls=GeneralizedRCNN, **kw):
        m = cls(**kw, dtype=dtype)
        m.load_state_dict(states[state])
        return m.to(dev)

    canvas, hw, orig = cases.tiny_inputs(True)
    images = cases.image_batch(canvas, hw, orig)
    gt = cases.gt_instances(*cases.tiny_gt(hw))
    flat = cases.image_batch(*cases.tiny_inputs(False))
    boxes = torch.from_numpy(cases.pooled_boxes())
    with torch.no_grad():
        for stride in (True, False):
            m = model("flagship", **cases.tiny_kwargs(stride)).eval()
            res4, _ = m.compute_features(images.to(dev))
            shared.setdefault(("res4", stride), res4.cpu())
            out[("t", f"features s1x1={stride}", "res4")] = _np(res4)
            # pooled features, every arm fed T''s bf16 res4
            x = shared[("res4", stride)].to(dev, dtype)
            out[("t", f"features s1x1={stride}", "pooled")] = _np(
                m.roi_heads.pooled_features(x, boxes.to(dev)))
            for padded in ((False, True) if stride else (True,)):
                batch = images if padded else flat
                out[("d", f"infer s1x1={stride} padded={padded}", "")] = \
                    _bf16_dets(m.forward_inference(batch.to(dev)))
            if stride:
                head = m.proposal_generator.rpn_head(
                    m.branch_features(res4)[0])
                shared.setdefault("rpn_head", tuple(t.cpu() for t in head))
                for name, t in zip(("logits", "deltas"), head):
                    out[("t", "rpn head", name)] = _np(t)
                # TPU.DEVICE_PREPROCESS: the raw batch resized on the device
                raw, rhw, rorig, short, flip = cases.raw_batch()
                pre = preprocess_batch(
                    cases.image_batch(raw, rhw, rorig).to(dev),
                    {"short": short, "flip": flip,
                     "target_hw": (cases.H, cases.W), "max_size": cases.W})
                out[("t", "device preprocess", "resized")] = _np(pre.image)
                out[("d", "device preprocess", "")] = _bf16_dets(
                    m.forward_inference(pre))
        m = model("standard", **cases.tiny_kwargs(
            roi_heads_name="StandardROIHeads", box_convfc=(1, 32, 2, 64)))
        out[("d", "infer StandardROIHeads", "")] = _bf16_dets(
            m.eval().forward_inference(images.to(dev)))
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    pred = DefaultPredictor(cases.predictor_cfg(name), device=dev,
                            state_dict=states["predictor"])
    out[("d", "predict_batch", "")] = [
        (o["boxes"], o["classes"])
        for o in pred.predict_batch(cases.predictor_images())]
    cfg = cases.export_cfg(name)
    if dev.type == "cuda" and dtype == torch.bfloat16:
        # the card serves an exported bf16 program; the CPU arms eager
        meta, programs = export_inference(cfg, states["export"], batch=1,
                                          device="cuda")
        path = os.path.join(tmp, "bf16_vs_cpu.fsodtf-torch")
        save_serving_artifact(path, meta, programs, states["export"])
        serve = ServingPredictor(path, device="cuda")
    else:
        serve = DefaultPredictor(cfg, device=dev,
                                 state_dict=states["export"])
    out[("d", "export", "")] = [(o["boxes"], o["classes"]) for o in
                                map(serve, cases.export_images())]

    # training: losses and every gradient, draws on the host
    def train(m, case):
        m.train()
        losses = m.forward_train(images.to(dev), gt.to(dev),
                                 *step_generators(0, 0, "cpu"))
        sum(v for k, v in losses.items()
            if not k.startswith("metric/")).backward()
        for k, v in losses.items():
            if not k.startswith("metric/"):
                out[("t", case, k)] = _np(v)
        for n, p in m.named_parameters():
            out[("t", case, n)] = (np.zeros(p.shape, np.float32)
                                   if p.grad is None else _np(p.grad))
        return m

    train_kw = dict(cases.tiny_kwargs(), **cases.train_kwargs())
    train(model("flagship", **train_kw), "train")
    for meta_arch in cases.TEXT_ARCHS:
        cls, extra = text_heads.META_ARCHS[meta_arch]
        m = train(model(meta_arch, cls, **extra,
                        **cases.text_kwargs(meta_arch)), meta_arch)
        with torch.no_grad():
            out[("d", f"infer {meta_arch}", "")] = _bf16_dets(
                m.eval().forward_inference(images.to(dev), gt.to(dev)))
    # three SGD steps of make_train_step: each parameter's update
    cfg = cases.step_cfg(CONFIG)
    m = model("flagship", **train_kw).train()
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    opt = build_optimizer(cfg, m)
    step = make_train_step(m, opt, build_scheduler(cfg, opt),
                           build_gradient_clipper(cfg), seed=0,
                           draw_device="cpu")
    for it in range(3):
        step(images.to(dev), gt.to(dev), it)
    for n, p in m.named_parameters():
        out[("t", "3 SGD steps", n)] = (p.detach().double()
                                        - before[n].double()).cpu().numpy()
    return out


def _bf16_same_inputs(rule, rpn_head):
    """Rule 2 on the card: proposals from T''s bf16 RPN head outputs and
    final detections from bf16-rounded box-head outputs, on the card and
    on the CPU."""
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        cell_anchors,
        fast_rcnn_inference,
        select_top_proposals,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        bf16_parity as cases,
    )

    devs = (torch.device("cuda"), torch.device("cpu"))
    logits, deltas = rpn_head
    hw = torch.from_numpy(cases.tiny_inputs(True)[1])
    for pre, post in ((1200, 300), (600, 1000)):
        a, b = (select_top_proposals(logits.to(d), deltas.to(d),
                                     cell_anchors(),
                                     (cases.H // 16, cases.W // 16), 16,
                                     hw.to(d), pre, post)
                for d in devs)
        ok = (torch.equal(a.valid.cpu(), b.valid)
              and torch.equal(a.objectness.cpu(), b.objectness)
              and float((a.boxes.cpu() - b.boxes).abs().max()) <= 1e-4)
        rule.same(f"proposals top-k {pre}/{post}", ok,
                  "valid, objectness, boxes (1e-4)")
    args, kw = cases.head_outputs()
    a, b = (fast_rcnn_inference(*(torch.from_numpy(x).to(d) for x in args),
                                **kw)
            for d in devs)
    ok = (torch.equal(a[3].cpu(), b[3]) and torch.equal(a[2].cpu(), b[2])
          and bool(b[3].sum() > 10)
          and torch.allclose(a[1].cpu(), b[1], rtol=1e-6, atol=1e-7)
          and torch.allclose(a[0].cpu(), b[0], rtol=1e-6, atol=1e-4))
    rule.same("final detections", ok,
              "valid, classes, scores (1e-6), boxes (1e-4)")


def _bf16_compare(rule, arms):
    """Rules 1 and 3 over the arms' outputs, key by key."""
    c, t, r = arms["C"], arms["T'"], arms["R'"]
    for key in r:
        kind, case, name = key
        if kind == "t":
            if not (abs(r[key]).max() > 0):
                # a parameter a loss never reaches: zero on every arm
                if abs(c[key]).max() > 0 or abs(t[key]).max() > 0:
                    rule.failed.append(f"{case} {name}: nonzero where R' "
                                       "is zero")
                continue
            rule.tensors(case, name, c[key], t[key], r[key])
        else:
            rule.detections(case, c[key], t[key], r[key], held=kind == "d")


def _bf16_full_opts():
    """(b)'s options: the image stays at 512x853 in the 512x864 bucket; the
    confident detections are the valid ones; the stem trains, so that all
    nine gradients exist."""
    return ["INPUT.MIN_SIZE_TEST", str(BF16_FULL_HW[0]),
            "INPUT.MAX_SIZE_TEST", "864",
            "MODEL.ROI_HEADS.SCORE_THRESH_TEST", str(BF16_CONFIDENT),
            "MODEL.BACKBONE.FREEZE_AT", "0"]


def _bf16_spread(f, shape, gen, std):
    """A weight of ``shape`` (K outputs) and a (K,) bias drawn around the
    features ``f`` (N, C), float64: each output a random mix of the K
    leading principal directions of ``f`` (where the features differ most
    from one row to the next, so that a device's roundings move the
    outputs least), the bias centring it on ``f``'s mean, both scaled by
    ``std`` (a number, or a function of the unit-spread outputs that
    returns the scale) so that the outputs over ``f`` spread by it."""
    import torch

    k = shape[0]
    mu = f.mean(0)
    v = torch.linalg.svd(f - mu, full_matrices=False)[2][:k]
    w = torch.randn(k, k, generator=gen, dtype=torch.float64) @ v
    z = (f - mu) @ w.T
    z = z / z.std()
    g = std(z) if callable(std) else std
    w = w * (g / float(((f - mu) @ w.T).std()))
    return w.float().reshape(shape), (-(w @ mu)).float()


def _bf16_full_state(opts, image):
    """(b)'s float32 weights: seeded, the conv3s drawn small (a block adds
    to its shortcut), then the RPN's and the box predictor's output layers
    drawn around the image's own features (a float32 pass on the CPU for
    each) by ``_bf16_spread``. Seeded heads read a random R-101's features,
    whose common part dwarfs what tells one position or box from another:
    every objectness is a near-tie, half the proposals are boxes of zero
    width, and every box scores one class near 1. Drawn: the objectness
    and the box deltas spread by BF16_HEAD_STD, and the classifier by the
    gain at which BF16_CONFIDENT_SHARE of the proposals' best foreground
    scores reach BF16_CONFIDENT."""
    import torch
    import torch.nn.functional as F
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        DefaultPredictor,
    )

    pred = DefaultPredictor(_cfg("float32", opts), device="cpu", seed=0)
    state = pred.model.state_dict()
    gen = torch.Generator().manual_seed(19)
    for name in list(state):
        if name.endswith("conv3.weight"):
            w = state[name]
            state[name] = torch.randn(w.shape, generator=gen) * (
                0.2 / w[0].numel() ** 0.5)

    def features(module, hook):
        """The input of ``module`` in a float32 pass over the image."""
        pred.model.load_state_dict(state)
        got = []
        handle = module.register_forward_pre_hook(
            lambda m, args: got.append(hook(m, args[0])))
        try:
            with torch.no_grad():
                pred(image)
        finally:
            handle.remove()
        return torch.cat(got)

    def rpn_hidden(head, x):  # the RPN conv's relu output, (H*W, C)
        t = F.relu(F.conv2d(x, head.conv.weight, head.conv.bias, padding=1))
        return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1]).double()

    def draw(prefix, f, std):
        state[prefix + "weight"], state[prefix + "bias"] = _bf16_spread(
            f, state[prefix + "weight"].shape, gen, std)

    rpn = "proposal_generator.rpn_head."
    f = features(pred.model.proposal_generator.rpn_head, rpn_hidden)
    draw(rpn + "objectness_logits.", f, BF16_HEAD_STD)
    draw(rpn + "anchor_deltas.", f, BF16_HEAD_STD)
    numbers = dict(rpn_positions=len(f))
    f = features(pred.model.roi_heads.box_predictor,
                 lambda m, x: x.double())

    def gain(z):  # the background is the last class
        def share(g):
            best = torch.softmax(g * z, -1)[:, :-1].max(-1).values
            return float((best >= BF16_CONFIDENT).double().mean())

        lo, hi = 0.0, 64.0
        for _ in range(40):
            mid = (lo + hi) / 2
            lo, hi = ((mid, hi) if share(mid) < BF16_CONFIDENT_SHARE
                      else (lo, mid))
        numbers.update(classifier_gain=hi, confident_share=share(hi))
        return hi

    box = "roi_heads.box_predictor."
    draw(box + "cls_score.", f, gain)
    draw(box + "bbox_pred.", f, BF16_HEAD_STD)
    return state, dict(numbers, proposals=len(f))


def _bf16_full_width(rule, card="cuda", batch=BF16_FULL_BATCH):
    """(b) full R-101 width at the 512x864 bucket: one image through
    ``DefaultPredictor`` (res4, pooled features fed T''s res4, and the
    confident detections: held on T''s proposals, reported on each arm's
    own), then one training step at ``batch`` on one batch with the host's
    draws and T''s proposals handed to every arm, so that every arm
    samples the same anchors and ROIs (the losses, the sampled counts and
    the nine gradients). At this depth the card's bf16 is as far from the
    CPU's as the CPU's is from its float32 (tools/bf16_card_vs_cpu.py
    convs), so discrete outputs downstream of the proposals' selection
    are compared, not held. The card's arm runs twice: once counted, once
    with its kernel calls captured. Returns (launches, captured calls,
    numbers)."""
    import numpy as np
    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        DefaultPredictor,
        step_generators,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        build_model,
    )

    t0 = time.perf_counter()
    opts = _bf16_full_opts()
    image = _synthetic_images(19, 1, *BF16_FULL_HW)[0]
    state, calib = _bf16_full_state(opts, image)
    numbers = dict(calibration=calib,
                   setup_s=time.perf_counter() - t0)
    rng = np.random.RandomState(19)
    xy = rng.uniform(0, [BF16_FULL_HW[1] - 200, BF16_FULL_HW[0] - 200],
                     (1, 256, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(16, 200, (1, 256, 2))], -1).astype(np.float32))
    (train_images, train_gt), = train_batches(
        19, 1, batch, h=BF16_FULL_HW[0], w=BF16_FULL_HW[1],
        bucket=(512, 864))
    case = f"full width train step, batch {batch}"
    shared = {}

    def hand(run_rpn, key):
        """``run_rpn`` returning the first arm's (T''s) proposals."""
        def handed(feat_rpn, images, train):
            logits, deltas, own = run_rpn(feat_rpn, images, train)
            given = shared.setdefault(key, own.to("cpu"))
            return logits, deltas, given.to(feat_rpn.device)
        return handed

    def arm(dev, dt):
        cfg = _cfg(dt, opts)
        pred = DefaultPredictor(cfg, device=dev, state_dict=state)
        out = {}
        # end to end, each arm on its own proposals: reported, not held;
        # its res4 read on the way
        feats = []
        hook = pred.model.backbone.register_forward_hook(
            lambda m, args, o: feats.append(o["res4"].detach()))
        try:
            o = pred(image)
        finally:
            hook.remove()
        out[("e", "full width predictor, own proposals", "")] = [
            (o["boxes"], o["classes"])]
        shared.setdefault("res4", feats[0].cpu())  # T''s, fed to every arm
        out[("t", "full width predictor", "res4")] = _np(feats[0])
        with torch.no_grad():
            x = shared["res4"].to(pred.device, pred.model.dtype)
            out[("t", "full width predictor", "pooled")] = _np(
                pred.model.roi_heads.pooled_features(
                    x, boxes.to(pred.device)))
        # held: the box head, box decoding and final NMS on T''s proposals
        pred.model.run_rpn = hand(pred.model.run_rpn, "test proposals")
        o = pred(image)
        out[("d", "full width predictor, T' proposals", "")] = [
            (o["boxes"], o["classes"])]
        diag = dict(confident=len(o["scores"]))
        del pred
        model = build_model(cfg)
        model.load_state_dict(state)
        model.to(dev).train()
        model.run_rpn = hand(model.run_rpn, "proposals")
        losses = model.forward_train(train_images.to(dev), train_gt.to(dev),
                                     *step_generators(0, 0, "cpu"))
        sum(v for k, v in losses.items()
            if not k.startswith("metric/")).backward()
        for k, v in losses.items():
            if not k.startswith("metric/"):
                out[("t", case, k)] = _np(v)
        diag.update(fg=float(losses["metric/roi_num_fg_samples"]),
                    pos_anchors=float(losses["metric/rpn_num_pos_anchors"]))
        named = dict(model.named_parameters())
        for n in BF16_GRADS:
            out[("t", case, n)] = _np(named[n].grad)
        del model, losses, named
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        return out, diag

    arms, diags, secs = {}, {}, {}
    for name, dev, dt in (("T'", "cpu", "bfloat16"),
                          ("R'", "cpu", "float32")):
        s0 = time.perf_counter()
        arms[name], diags[name] = arm(dev, dt)
        secs[name] = time.perf_counter() - s0
    s0 = time.perf_counter()
    read = _reset_counts()
    arms["C"], diags["C"] = arm(card, "bfloat16")
    launches = read()
    secs["C"] = time.perf_counter() - s0
    calls = None
    if torch.device(card).type == "cuda":
        s0 = time.perf_counter()
        calls = _plain_copies(capture_kernel_inputs(
            lambda: arm(card, "bfloat16")))
        secs["C captured"] = time.perf_counter() - s0
    log(f"bf16 vs CPU (b): classifier {calib}; by arm {diags}")
    for k in ("fg", "pos_anchors"):
        rule.same(f"{case}: sampled {k}",
                  all(d[k] == diags["T'"][k] for d in diags.values()),
                  f"{k} on every arm, T''s proposals handed to each")
    _bf16_compare(rule, arms)
    numbers.update(seconds=secs, diag=diags)
    return launches, calls, numbers


def phase_bf16_vs_cpu(card, out_dir=None):
    """Phase 19 under the backend flags of a fresh process, as the port
    serves and trains in bf16 (earlier phases turn cuDNN's TF32 off), each
    restored after."""
    import torch

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    cudnn.deterministic = cudnn.benchmark = False
    try:
        return _phase_bf16_vs_cpu(card, out_dir)
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved


def _check_captured(label, calls, launches):
    """Every captured NMS, ROIAlign forward and backward call held to its
    plain version (bf16 ROIAlign within ROI_BF16_TOL), and the captured
    counts equal to the counted run's launches."""
    import torch

    k0 = time.perf_counter()
    for i, args in enumerate(calls["nms"]):
        check_nms(f"{label}_{i}", *args)
    for i, args in enumerate(calls["roi_align"]):
        check_roi_align(f"{label}_{i}", args,
                        ROI_BF16_TOL if args[0].dtype == torch.bfloat16
                        else ROI_F32_TOL, reps=3)
    for i, args in enumerate(calls["roi_align_bwd"]):
        check_roi_align_bwd(f"{label}_{i}", args, reps=3)
    log(f"bf16 vs CPU {label}: every captured kernel call held to its plain "
        f"version: NMS {len(calls['nms'])}, ROIAlign forward "
        f"{len(calls['roi_align'])}, backward {len(calls['roi_align_bwd'])} "
        f"({time.perf_counter() - k0:.1f} s)")
    captured = {"greedy_nms": len(calls["nms"]),
                "roi_align_v2_fwd": len(calls["roi_align"]),
                "roi_align_v2_bwd": len(calls["roi_align_bwd"])}
    if launches != captured:
        raise PhaseError(f"bf16 vs CPU {label}: launches {launches} against "
                         f"the captured calls {captured}")


def _phase_bf16_vs_cpu(card, out_dir):
    """19. The default compute dtype, bfloat16, on the card against the
    CPU (rule 4 of the bf16 parity tests: C the card's bf16, T' the CPU's
    bf16, R' the CPU's float32, the port alone): (a) every case of
    tests/test_torch_bf16_*.py (tools/bf16_parity.py) at their tiny size,
    counted, then again with every kernel call captured and held to its
    plain version; (b) one image and one training step at full R-101 width
    at the 512x864 bucket, its kernel calls captured and held likewise.
    ``out_dir``: where each comparison's two sides go (bf16_vs_cpu.json).
    Returns ({path: launches}, numbers)."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    flags = dict(
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        cudnn_deterministic=torch.backends.cudnn.deterministic,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        bf16_reduced_reduction=torch.backends.cuda.matmul
        .allow_bf16_reduced_precision_reduction)
    rule = _Rule4()
    states = _bf16_tiny_states()
    arms, shared = {}, {}
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for arm, dev, dt in (("T'", "cpu", torch.bfloat16),
                             ("R'", "cpu", torch.float32)):
            s0 = time.perf_counter()
            arms[arm] = _bf16_tiny_arm(dev, dt, states, shared, tmp)
            secs[arm] = time.perf_counter() - s0
        s0 = time.perf_counter()
        read = _reset_counts()
        arms["C"] = _bf16_tiny_arm("cuda", torch.bfloat16, states, shared,
                                   tmp)
        _bf16_same_inputs(rule, shared["rpn_head"])
        tiny_launches = read()
        secs["C"] = time.perf_counter() - s0
        _bf16_compare(rule, arms)
        log(f"bf16 vs CPU (a) tiny: {rule.summary()}; launches "
            f"{tiny_launches}; seconds by arm "
            f"{ {k: round(v, 1) for k, v in secs.items()} }")
        calls = capture_kernel_inputs(lambda: (
            _bf16_tiny_arm("cuda", torch.bfloat16, states, shared, tmp),
            _bf16_same_inputs(_Rule4(), shared["rpn_head"])))
    _check_captured("(a)", calls, tiny_launches)
    n_tiny = len(rule.rows)
    full_launches, full_calls, full = _bf16_full_width(rule)
    rows_b = rule.rows[n_tiny:]
    log(f"bf16 vs CPU (b) full width: " + "; ".join(
        f"{r['case']} {r['name']}: " + (
            f"e(C) {r['e_card']:.4e}, e(T') {r['e_cpu_bf16']:.4e}"
            if r["rule"] == 1 else
            f"C matches {r['card_in_cpu_bf16']} in T', T' "
            f"{r['cpu_bf16_in_f32']} in R' of {r['valid']}"
            + ("" if r["held"] else " (reported, not held)")
            if r["rule"] == 3 else f"equal {r['equal']}")
        for r in rows_b) + f"; launches {full_launches}; seconds "
        f"{ {k: round(v, 1) for k, v in full['seconds'].items()} }, "
        f"set-up {full['setup_s']:.1f}")
    _check_captured("(b)", full_calls, full_launches)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "bf16_vs_cpu.json"), "w") as f:
            json.dump(dict(card=card, flags=flags, rows=rule.rows,
                           full_width=full, failed=rule.failed), f,
                      indent=1, default=str)
    secs_total = time.perf_counter() - t0
    zero = [k for k in KERNEL_NAMES
            if not tiny_launches[k] or not full_launches[k]]
    if zero:
        raise PhaseError(f"bf16 vs CPU: no launch of {zero} "
                         f"({tiny_launches}, {full_launches})")
    if rule.failed:
        raise PhaseError("bf16 vs CPU: rule 4 fails: "
                         + "; ".join(rule.failed))
    log(f"bf16 vs CPU summary (phase 19; {card}): {len(rule.rows)} "
        f"comparisons hold; (b) {rule.summary(rows_b)}; card flags "
        f"{flags}; {secs_total:.1f} s")
    return {"bf16_vs_cpu_tiny": tiny_launches,
            "bf16_vs_cpu_full_width": full_launches}, dict(
                seconds=secs_total, rows=rule.rows)


# ----------------------------------------------------------------- phase 20
PORT_TOOLS = os.path.join(
    ROOT, "fewshotobjectdetection_imporove_via_text_feature_torch", "tools")
PORT_MODULE = "fewshotobjectdetection_imporove_via_text_feature_torch"
# (b)'s working directory: its configs/voc/defrcn_det_r101_base1.yaml is
# the shipped config with this schedule, its evaluation at EVAL_THRESHOLDS
# with PCB on (the base config leaves PCB off; the visualizer needs
# detections to draw); its datasets/ holds phase 9's images and
# annotations with each year's image sets cut to their first ENTRY_IMAGES
# (one evaluation batch of 32): each script evaluates the test set, and
# phase 9's 800 made a CLI's evaluation 30 s on an H100 (700 W)
ENTRY_STEPS = 10
ENTRY_IMAGES = 32
ENTRY_YAML = """_BASE_: "{base}"
MODEL:
  ROI_HEADS: {{SCORE_THRESH_TEST: 0.0}}
SOLVER: {{MAX_ITER: {steps}, CHECKPOINT_PERIOD: 0}}
TEST: {{PCB_ENABLE: True, PCB_LOWER: 0.0}}
SEED: 0
"""
ENTRY_SCRIPTS = ("run_text_train_teacher.sh", "run_visualize.sh")
_ANSI = "\033[32m", "\033[31m", "\033[0m"


def _plain(text):
    for code in _ANSI:
        text = text.replace(code, "")
    return text


def _entry_start(cmd, cwd, env):
    """``cmd`` started as a subprocess, its output kept."""
    return subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), \
        time.perf_counter()


def _entry_finish(started, label):
    """Wait for a process of ``_entry_start``. Returns (exit code, output,
    seconds from its start)."""
    proc, t0 = started
    text = proc.communicate()[0]
    secs = time.perf_counter() - t0
    log(f"entry points: {label} exit {proc.returncode} in {secs:.1f} s")
    return proc.returncode, _plain(text), secs


def _preflight_items(text):
    """{item: "OK" or "MISSING"} of a preflight report."""
    items = {}
    for ln in text.splitlines():
        if ln.startswith("[OK] ") or ln.startswith("[MISSING] "):
            verdict, name = ln[1:].split("] ", 1)
            items[name] = verdict
    return items


def _entry_datasets(src, dst, images):
    """``dst``: the VOC trees of ``src`` (images and annotations linked),
    each year's trainval and test sets cut to their first ``images``."""
    for year in ("VOC2007", "VOC2012"):
        sets = os.path.join(dst, year, "ImageSets", "Main")
        os.makedirs(sets)
        for sub in ("Annotations", "JPEGImages"):
            os.symlink(os.path.join(src, year, sub),
                       os.path.join(dst, year, sub))
        for split in ("trainval", "test"):
            with open(os.path.join(src, year, "ImageSets", "Main",
                                   split + ".txt")) as f:
                ids = [ln.strip() for ln in f if ln.strip()][:images]
            with open(os.path.join(sets, split + ".txt"), "w") as f:
                f.write("\n".join(ids))


def phase_entry_points(tmp, workflow, coco_root, tv_pth, card):
    """20. The repository's entry points on the port. (a) the preflights on
    phase 9's and 10's synthetic trees and phase 9's full-size seeded
    weights: the weight items OK, the tree items refused, exit 1, and
    run_real_voc.sh stopping at its gate with no output directory, run
    beside the class embeddings' generation and (b)'s first script; (b)
    run_text_train_teacher.sh and run_visualize.sh, unmodified, from a
    scratch working directory whose configs/voc holds the shipped base
    config with a short schedule, then the similarity figure beside the
    drawings; (c) the kernels on one training step and one evaluation
    batch of (b)'s teacher, against their plain versions. Returns ({path:
    launches}, numbers)."""
    import math

    import torch
    from fewshotobjectdetection_imporove_via_text_feature_torch import cli
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
        register_all,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        Trainer,
    )

    t_phase = time.perf_counter()
    os.makedirs(tmp, exist_ok=True)
    out = {}
    voc, pkl = workflow["datasets"], workflow["pkl"]
    # the scripts run as a user starts them: no DEVICE (cuda is their
    # default), datasets under the working directory
    env = {k: v for k, v in os.environ.items()
           if k not in ("DEVICE", "FSODTF_DATASETS", "PYTHONPATH")}
    tool_env = dict(env, PYTHONPATH=ROOT)

    def tool(name, *args):
        return [sys.executable, "-m", f"{PORT_MODULE}.tools.{name}", *args]

    # (b)'s working directory
    wd = os.path.join(tmp, "entry")
    datasets = os.path.join(wd, "datasets")
    config = os.path.join(wd, "configs", "voc", "defrcn_det_r101_base1.yaml")
    os.makedirs(os.path.dirname(config))
    os.makedirs(os.path.join(wd, "tools"))
    with open(config, "w") as f:
        f.write(ENTRY_YAML.format(base=CONFIG, steps=ENTRY_STEPS))
    for name in ("create_config.py", "extract_results.py"):
        os.symlink(os.path.join(ROOT, "tools", name),
                   os.path.join(wd, "tools", name))
    _entry_datasets(voc, datasets, ENTRY_IMAGES)

    # (a) the preflights, as the run scripts call them, from the repo root,
    # and the class embeddings, all started together
    weights = ("--r101", pkl, "--pcb", tv_pth)
    save = os.path.join(tmp, "real_voc")
    started = {
        "voc": _entry_start(tool("preflight_real_voc", "--root", voc,
                                 "--shot", "10", "--seeds", "0", *weights),
                            ROOT, tool_env),
        "coco": _entry_start(tool("preflight_real_coco", "--root",
                                  coco_root, "--shot", "1", "--seeds", "0",
                                  *weights), ROOT, tool_env),
        "gate": _entry_start(
            ["bash", os.path.join(PORT_TOOLS, "run_real_voc.sh")], tmp,
            dict(env, DATA_ROOT=voc, IMAGENET_PRETRAIN=pkl,
                 PCB_PRETRAIN=tv_pth, SAVE_DIR=save)),
    }
    walls = {}
    rc, text, walls["generate_class_embeddings"] = _entry_finish(
        _entry_start(tool("generate_class_embeddings"), wd, tool_env),
        "generate_class_embeddings")
    if rc != 0:
        raise PhaseError(f"generate_class_embeddings: exit {rc}:\n{text}")

    # (b) the teacher's script, while (a) runs on
    counts_file = os.path.join(tmp, "entry_launches.jsonl")
    open(counts_file, "w").close()
    env_b = dict(env, IMAGENET_PRETRAIN=pkl, PCB_PRETRAIN=tv_pth,
                 FSODTF_LAUNCH_COUNTS=counts_file)
    teacher_run = _entry_start(
        ["bash", os.path.join(PORT_TOOLS, ENTRY_SCRIPTS[0])], wd, env_b)

    trees = {"voc": ("VOC2007 tree", "VOC2012 tree"),
             "coco": ("coco/trainval2014 tree", "coco/val2014 tree",
                      "cocosplit/datasplit jsons")}
    for key in ("voc", "coco"):
        rc, text, secs = _entry_finish(started[key], f"preflight_real_{key}")
        items = _preflight_items(text)
        bad = [w for w in ("R-101.pkl import coverage",
                           "PCB torchvision weights")
               if items.get(w) != "OK"] + [
            t for t in trees[key] if items.get(t) != "MISSING"]
        if rc != 1 or bad or "Nothing was started." not in text or (
                "synthetic smoke data" not in text):
            raise PhaseError(f"preflight_real_{key}: exit {rc}, items "
                             f"{items} ({bad} wrong):\n{text[-2000:]}")
        out[f"preflight_{key}"] = dict(items=items, seconds=secs)
    rc, text, secs = _entry_finish(started["gate"], "run_real_voc.sh")
    if rc == 0 or "Preflight FAILED" not in text or os.path.exists(save):
        raise PhaseError(f"run_real_voc.sh: exit {rc}, output directory "
                         f"{'written' if os.path.exists(save) else 'absent'}"
                         f":\n{text[-2000:]}")
    log(f"entry points (a): both preflights pass the full-size seeded "
        f"R-101 .pkl and torchvision .pth and refuse the synthetic trees "
        f"(VOC {out['preflight_voc']['items']}; COCO "
        f"{out['preflight_coco']['items']}), exit 1; run_real_voc.sh stops "
        f"at its gate (exit {rc}, {secs:.1f} s), no output directory")

    teacher = os.path.join(wd, "outputs", "singleHeadAtt_Text",
                           "teacher_base", "defrcn_det_r101_base1")
    final = os.path.join(teacher, "model_final.pth")
    figure = os.path.join(teacher, "similarity.png")
    figure_run = None
    for i, script in enumerate(ENTRY_SCRIPTS):
        rc, text, walls[script] = _entry_finish(
            teacher_run if i == 0 else _entry_start(
                ["bash", os.path.join(PORT_TOOLS, script)], wd, env_b),
            script)
        with open(os.path.join(tmp, script + ".log"), "w") as f:
            f.write(text)
        if rc != 0:
            raise PhaseError(f"{script}: exit {rc}; last output:\n"
                             f"{text[-3000:]}")
        if i == 0:  # the similarity figure beside run_visualize.sh
            figure_run = _entry_start(
                tool("visualize_confusion_matrix", "--output", figure), wd,
                tool_env)
    rc, text, walls["visualize_confusion_matrix"] = _entry_finish(
        figure_run, "visualize_confusion_matrix")
    if rc != 0:
        raise PhaseError(f"visualize_confusion_matrix: exit {rc}:\n{text}")
    with open(os.path.join(teacher, "coco_instances_results.json")) as f:
        dets = json.load(f)
    drawn = os.listdir(os.path.join(teacher, "visualizations"))
    images = len({d["image_id"] for d in dets})
    figures = [p for p in (figure, figure[:-4] + ".csv")
               if os.path.exists(p)]
    missing = [p for p in (final, os.path.join(
        teacher, "model_reset_surgery.pth")) if not os.path.isfile(p)]
    if missing or not dets or images != ENTRY_IMAGES or \
            len(drawn) != images or not figures:
        raise PhaseError(f"entry points (b): missing {missing}, "
                         f"{len(dets)} detections on {images} images, "
                         f"{len(drawn)} drawn, figure {figures}")

    # the launches the two CLI processes owe, as phase 9 works them out
    os.environ["FSODTF_DATASETS"] = datasets
    register_all(datasets)
    cfg = get_cfg()
    cfg.merge_from_file(config)
    runs = [json.loads(ln) for ln in open(counts_file) if ln.strip()]
    batches = -(-ENTRY_IMAGES // cli.EVAL_BATCH_SIZE)
    step_chunks = -(-cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
                    // cfg.TPU.ROI_CHUNK)
    chunks = -(-cfg.MODEL.RPN.POST_NMS_TOPK_TEST // cfg.TPU.ROI_CHUNK)
    proto, per_batch = pcb_expected_launches(cfg)
    evaluation = {"greedy_nms": 2 * batches,
                  "roi_align_v2_fwd": chunks * batches + proto
                  + per_batch * batches, "roi_align_v2_bwd": 0}
    training = {"greedy_nms": ENTRY_STEPS,
                "roi_align_v2_fwd": step_chunks * ENTRY_STEPS,
                "roi_align_v2_bwd": step_chunks * ENTRY_STEPS}
    want = [{k: v + training[k] for k, v in evaluation.items()}, evaluation]
    counts = {path: {k: r[k] for k in KERNEL_NAMES} for path, r in zip(
        ("entry_points_text_teacher", "entry_points_visualize"), runs)}
    if len(runs) != 2 or list(counts.values()) != want:
        raise PhaseError(f"entry points (b): {len(runs)} CLI processes "
                         f"reported {counts}, expected {want}")
    # the evaluation's own scrape: AP50 of log.txt's last copypaste row
    ap50 = _gate_metric(os.path.join(teacher, "log.txt"), 1)
    if not math.isfinite(ap50):
        raise PhaseError(f"run_visualize.sh: AP50 {ap50}")
    out.update(walls=walls, detections=len(dets), drawn=len(drawn),
               counts=counts)
    log(f"entry points (b) ({card}): generate_class_embeddings, "
        f"run_text_train_teacher.sh ({ENTRY_STEPS} "
        f"{cfg.TPU.COMPUTE_DTYPE} steps at batch "
        f"{cfg.SOLVER.IMS_PER_BATCH}, R-{cfg.MODEL.RESNETS.DEPTH} at its "
        f"widths, randinit surgery), run_visualize.sh (--eval-only with PCB "
        f"on {ENTRY_IMAGES} images, {len(dets)} detections, {len(drawn)} "
        f"images drawn), visualize_confusion_matrix "
        f"({os.path.basename(figures[0])}); wall by step "
        f"{({k: round(v, 1) for k, v in walls.items()})} s; AP50 "
        f"{ap50:.4f} (seeded weights: plumbing, not accuracy); launches "
        f"{counts} as expected")

    # (c) the kernels on one training step and one evaluation batch of the
    # teacher, from its trained weights and (b)'s class vectors
    teacher_opts = (*TEACHER_OPTS, "MODEL.ADDITION.EMBEDDING_PATH", datasets)
    cfg.merge_from_list(["MODEL.WEIGHTS", final, "TEST.PCB_MODELPATH",
                         tv_pth, "OUTPUT_DIR", os.path.join(tmp, "step"),
                         *teacher_opts])
    tr = Trainer(cfg)
    tr.resume_or_load(resume=False)
    _check_next_step(tr, "entry_points_teacher_step",
                     launches=(1, step_chunks, step_chunks))
    del tr
    torch.cuda.empty_cache()
    out["pcb"] = check_eval_batch(config, final, cfg.DATASETS.TEST[0],
                                  tv_pth, chunks, "entry_points_eval_path",
                                  opts=teacher_opts)
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"entry points summary (phase 20; {card}): preflights and gate as "
        f"expected; scripts {({k: round(v, 1) for k, v in walls.items()})} "
        f"s; kernels held on the teacher's step and evaluation batch; "
        f"phase 20 took {out['seconds']:.1f} s")
    return counts, out


# ------------------------------------------------- optional: --profile
def _category(name: str) -> str:
    n = name.lower()
    if "fsod_nms" in n:
        return "greedy_nms kernel"
    if "fsod_roi_align_bwd" in n:
        return "roi_align bwd kernel"
    if "fsod_roi_align" in n:
        return "roi_align kernel"
    # cuDNN's convolutions (implicit GEMMs, named by pass) before cuBLAS's
    # GEMMs, which share the xmma and gemm words
    if any(w in n for w in ("conv", "cudnn", "implicit", "fprop", "dgrad",
                            "wgrad")):
        return "convolution"
    if "gemm" in n or "cutlass" in n or "xmma" in n:
        return "matmul"
    if "sort" in n or "radix" in n:
        return "sort"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other"


def profile_call(label, fn, out_dir, filename, key_dim=None):
    """Device time by kernel of one call of ``fn``, with torch.profiler;
    the full table goes to ``out_dir/filename``. With ``key_dim``, also the
    device time of the operations with an input of that size in some
    dimension (the cross-ROI attention's N + 1 keys: its QK^T, softmax and
    AV, forward and backward). Returns the numbers, or None when the
    profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=key_dim is not None) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    by_cat, ours = {}, {}
    for e in kernels:
        us = getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
        by_cat[_category(e.name)] = by_cat.get(_category(e.name), 0) + us
        if "fsod_" in e.name:  # this package's kernels, by name
            name = e.name[e.name.index("fsod_"):].split("(")[0].split("<")[0]
            ours.setdefault(name, []).append(us)
    busy_ms = sum(by_cat.values()) / 1e3
    if busy_ms <= 0:
        log(f"profile {label}: the profiler saw no device time; not "
            "measured")
        return None
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, filename), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=60))
    shares = {k: round(v / 1e3, 3) for k, v in
              sorted(by_cat.items(), key=lambda kv: -kv[1])}
    log(f"profile {label}: wall {wall * 1e3:.2f} ms, device busy "
        f"{busy_ms:.2f} ms (idle share {1 - busy_ms / (wall * 1e3):.3f}), "
        f"device ms by kind {shares}")
    log(f"profile {label}, this package's kernels (device ms, launches, us "
        "each): " + str({k: (round(sum(t) / 1e3, 4), len(t),
                             [round(u, 1) for u in t])
                         for k, t in sorted(ours.items())}))
    out = {"wall_ms": wall * 1e3, "busy_ms": busy_ms,
           "kernels_ms": sum(sum(t) for t in ours.values()) / 1e3}
    if key_dim is not None:
        # a CPU operation's own kernels (not its children's), so that each
        # kernel is counted once
        us = 0.0
        for e in events:
            shapes = getattr(e, "input_shapes", None) or []
            if any(isinstance(sh, (list, tuple)) and key_dim in sh
                   for sh in shapes):
                us += sum(getattr(k, "duration", 0)
                          for k in getattr(e, "kernels", []))
        out["key_dim_ms"] = us / 1e3
        log(f"profile {label}: operations over the {key_dim} keys "
            f"(QK^T, softmax, AV, forward and backward) {us / 1e3:.3f} ms "
            "of device time")
    return out


def phase_profile(pred, batch, out_dir):
    """One bf16 predict_batch(8), profiled."""
    profile_call("bf16 predict_batch(8)", lambda: pred.predict_batch(batch),
                 out_dir, "profile_bf16_batch8.txt")


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
    import tempfile

    # phases 9 and 10's data, made beside the build and phases 3-8
    data = tempfile.TemporaryDirectory()
    made = {"voc": start_voc(os.path.join(data.name, "voc", "datasets")),
            "coco": start_coco(os.path.join(data.name, "coco", "datasets"))}
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
    counts, calls, chunks, _ = phase_predictor(profile_dir)
    phase_main_path_inputs(calls, chunks)
    bwd = phase_roi_align_bwd(gen)
    kernels.append(dict(
        name="roi_align_v2_bwd", route="cuda",
        source="fewshotobjectdetection_imporove_via_text_feature_torch/csrc/roi_align.cu",
        replaces="fewshotobjectdetection_imporove_via_text_feature_tpu/ops/roi_align_mxu.py:69",
        launches=None, library_ms=None,
        **{k: bwd["bfloat16_B16_R256_P7_s2"][k] for k in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}))
    with tempfile.TemporaryDirectory() as tmp:
        phase_train_f32(tmp)
        per_step, train_counts, next_step = phase_train_bf16(
            tmp, profile_dir=profile_dir)
        phase_train_inputs(capture_kernel_inputs(next_step))
        del next_step
        torch.cuda.empty_cache()
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_weights import (
        write_torchvision_pth,
    )

    with data as tmp:
        # TEST.PCB_MODELPATH of phases 9 and 10: a torchvision R-101
        tv_pth = os.path.join(tmp, "resnet101.pth")
        write_torchvision_pth(tv_pth, seed=0)
        fed_counts, eval_counts, off_counts, workflow = phase_workflow(
            os.path.join(tmp, "voc"), tv_pth, profile_dir, made["voc"])
        coco_counts, coco = phase_coco(os.path.join(tmp, "coco"), tv_pth,
                                       made["coco"])
        text_counts, _ = phase_text(os.path.join(tmp, "text"), workflow,
                                    tv_pth, per_step, profile_dir)
        multi_counts, multi = phase_multi_device(os.path.join(tmp, "multi"),
                                                 workflow, per_step)
        entry_counts, _ = phase_entry_points(
            os.path.join(tmp, "entry_points"), workflow,
            os.path.join(tmp, "coco", "datasets"), tv_pth, card)
    with tempfile.TemporaryDirectory() as tmp:
        export_counts, server_counts, serving = phase_serving(tmp,
                                                              profile_dir)
        dp_counts, dp = phase_device_preprocess(tmp)
        std_counts, std_serve_counts, std_step, std_kernels = \
            phase_standard_heads(tmp)
        remat = phase_remat(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        learning_counts, _ = phase_learning(tmp)
    spatial_counts, _ = phase_spatial(card)
    with tempfile.TemporaryDirectory() as tmp:
        gate_counts, _ = phase_generalization(tmp, card)
        card_cpu_counts, _ = phase_card_vs_cpu(tmp, card)
    bf16_counts, _ = phase_bf16_vs_cpu(card)
    log(f"serving summary (phase 12; {card}): bf16 DefaultPredictor "
        f"requests {[round(x, 2) for x in serving['DefaultPredictor']['request_ms']]}"
        f" ms, predict_batch(8) "
        f"{serving['DefaultPredictor']['batch8_images_per_s']:.2f} images/s; "
        f"ServingPredictor requests "
        f"{[round(x, 2) for x in serving['ServingPredictor']['request_ms']]}"
        f" ms, predict_batch(8) "
        f"{serving['ServingPredictor']['batch8_images_per_s']:.2f} images/s; "
        f"export seconds a program f32 {serving['export_s_f32']}, bf16 "
        f"{serving['export_s_bf16']}; servers "
        f"{ {k: {m: round(v, 2) for m, v in d.items()} for k, d in serving.items() if k.startswith('server_')} }; "
        f"device-preprocessed step ms {[round(x, 2) for x in dp['step_ms']]}")
    log(f"StandardROIHeads summary (phase 13; {card}): bf16 step median "
        f"{std_step['median_ms']:.2f} ms (mean {std_step['window_ms']:.2f}),"
        f" peak {std_step['peak_gib']:.2f} GiB, beside phase 8 (b)'s "
        f"{per_step['median_ms']:.2f} ms and {per_step['peak_gib']:.2f} GiB; "
        f"ROIAlign at P 7, bin_stride 1 on a step's own inputs: forward "
        f"{std_kernels['fwd']['ms']:.4f} ms (graph "
        f"{std_kernels['fwd']['graph_ms']:.4f}, bound "
        f"{std_kernels['fwd']['bound_ms']:.4f} by "
        f"{std_kernels['fwd']['bound_by']}), backward "
        f"{std_kernels['bwd']['ms']:.4f} ms (graph "
        f"{std_kernels['bwd']['graph_ms']:.4f}, bound "
        f"{std_kernels['bwd']['bound_ms']:.4f} by "
        f"{std_kernels['bwd']['bound_by']}); remat peak "
        f"{remat['peak_gib']:.2f} GiB against {remat['peak_gib_no_remat']:.2f}"
        f" GiB without")
    pcb = workflow["pcb"]
    log(f"PCB summary (phases 9 and 10; {card}): VOC {_fmt_pcb(pcb)}; "
        f"evaluation {pcb['on_images_per_s']:.2f} images/s with PCB, "
        f"{pcb['off_images_per_s']:.2f} without; PCB's ROIAlign on an "
        f"evaluation batch's own inputs {pcb['launch_ms']:.4f} ms a launch "
        f"enqueued ({pcb['launch_graph_ms']:.4f} graph replay), bound "
        f"{pcb['launch_bound_ms']:.4f} ms; COCO {_fmt_pcb(coco)}; "
        f"evaluation {coco['images_per_s']:.2f} images/s; PCB's ROIAlign on "
        f"a COCO batch {coco['launch_ms']:.4f} ms a launch "
        f"({coco['launch_graph_ms']:.4f} graph replay)")
    log(f"workflow summary (phase 9 beside phase 8 (b); step ms from CUDA "
        f"events, no synchronize between steps): loader alone "
        f"{workflow['loader_images_per_s']:.2f} images/s; loader-fed step "
        f"median {workflow['fed_step_ms']:.2f} ms over all buckets (first "
        f"step of each left out), by bucket "
        f"{ {k: round(v, 2) for k, v in workflow['fed_step_ms_by_bucket'].items()} }"
        f" ms, mean over the run {workflow['fed_window_ms']:.2f} ms; one of "
        f"its batches at {workflow['resident_bucket']} stepped again with no "
        f"loader {workflow['resident_ms']:.2f} ms, with a loader decoding "
        f"beside it {workflow['contended_ms']:.2f} ms; resident batches at "
        f"800x1344 (phase 8 (b)) median {per_step['median_ms']:.2f} ms, "
        f"mean {per_step['window_ms']:.2f} ms; evaluation at batch "
        f"{workflow['eval_batch']} {workflow['eval_images_per_s']:.2f} "
        f"images/s")
    for k in kernels:
        name = k["name"]
        # every main path's launches: serving (phase 5), training on
        # resident batches (phase 8 (b)), the workflow's loader-fed
        # training, its fine-tune with evaluation (PCB on) and the
        # evaluation with PCB off (phase 9), and COCO (phase 10)
        k["launches_by_path"] = {
            "serving": counts[name], "training": train_counts[name],
            "workflow_training": fed_counts[name],
            "workflow_finetune_and_eval_pcb": eval_counts[name],
            "workflow_eval_pcb_off": off_counts[name],
            "coco_finetune_and_eval_pcb": coco_counts[name],
            **{path: c[name] for path, c in text_counts.items()},
            "export_serving": export_counts[name],
            "http_server": server_counts[name],
            "device_preprocess_training": dp_counts[name],
            "standard_roi_heads_training": std_counts[name],
            "standard_roi_heads_serving": std_serve_counts[name],
            **{path: c[name] for path, c in multi_counts.items()},
            **{path: c[name] for path, c in learning_counts.items()},
            "spatial_partition_serving": spatial_counts[name],
            **{path: c[name] for path, c in gate_counts.items()},
            **{path: c[name] for path, c in card_cpu_counts.items()},
            **{path: c[name] for path, c in bf16_counts.items()},
            **{path: c[name] for path, c in entry_counts.items()}}
        k["launches"] = sum(k["launches_by_path"].values())
        k["launches_per_train_step"] = per_step[name]
        if name != "greedy_nms":  # StandardROIHeads' launch shape
            k["bin_stride1_training"] = {
                m: std_kernels["fwd" if name == "roi_align_v2_fwd" else
                               "bwd"][m]
                for m in ("ms", "graph_ms", "plain_ms", "bound_ms",
                          "bound_by", "max_abs_err")}
        if name == "roi_align_v2_fwd":
            k["pcb_launches_by_path"] = {
                "workflow_finetune_and_eval_pcb": pcb["pcb_calls"],
                "coco_finetune_and_eval_pcb": coco["pcb_calls"]}
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
    finally:
        for p in _MAKERS:
            if p.poll() is None:
                p.kill()
                p.wait()
