"""Multi-device dry run on the CPU: N ranks over gloo, spawned, on a tiny
detector (depth 14, 128x160), each check against one process:

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.dryrun_multidevice \\
        [--ranks 2] [--workdir DIR]

  1. the flagship's data-parallel step (DDP) against one process's step on
     the global batch: losses, the sampled ROIs' valid counts (unequal
     across ranks) and every gradient;
  2. the same for the text student step (TextRes5ROIHeads with the
     distillation of run_text_train_student.sh: L2, KL, KL_TEMP 5), whose
     teacher attends over every rank's ROIs;
  3. TPU.MODEL_PARALLEL 2 (FSDP2 on a (ranks / 2, 2) mesh): two steps'
     losses and the first step's gradients equal to DP's, parameters and
     momentum sharded, and its checkpoint gathered, loaded back sharded and
     loaded by one process;
  4. evaluation sharded across the ranks on a synthetic VOC: every rank's
     metrics equal to one process's, the detections set-matched, and each
     rank decoding only its own batches.

It is the counterpart of the JAX package's ``dryrun_multichip``
(``__graft_entry__.py``). The rank workers (``step_worker``,
``eval_worker``, run in turn by ``tasks_worker`` so that one spawn serves
every check) live here so that spawned processes can import them; the
tests hand them the JAX package's weights as numpy arrays and compare
what they return with the JAX package's values. Prints one line a check
and exits non-zero on the first failure.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

# the tiny detector of the CPU tests
NUM_CLASSES = 5
H, W = 128, 160
SEM = 16
TINY = dict(
    num_classes=NUM_CLASSES, depth=14, stem_out_channels=8,
    res2_out_channels=16, width_per_group=4, freeze_at=0,
    rpn_pre_nms_topk=(1200, 1200), rpn_post_nms_topk=(64, 64),
    test_candidate_topk=64 * NUM_CLASSES)
# real sampling budgets and cls dropout: the draws choose, so the ranks
# must draw what one process draws
SAMPLED = dict(rpn_batch_per_image=64, roi_batch_per_image=128,
               cls_dropout=True)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each gradient's largest value

# the tiny detector through the config, for the evaluation
EVAL_OPTS = [
    "MODEL.WEIGHTS", "", "MODEL.DEVICE", "cpu",
    "MODEL.RESNETS.DEPTH", "14", "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "4", "MODEL.BACKBONE.FREEZE_AT", "0",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "128", "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
    "TPU.IMAGE_BUCKETS", "((192,256),)", "TPU.MAX_GT", "10",
    "TPU.MAX_DETECTIONS_PRE_NMS", "64", "TPU.COMPUTE_DTYPE", "float32",
    "INPUT.MIN_SIZE_TEST", "192", "INPUT.MAX_SIZE_TEST", "256",
]
EVAL_SET = "voc_2007_test_all1"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BASE1 = os.path.join(ROOT, "configs", "voc", "defrcn_det_r101_base1.yaml")


def text_bank(c=NUM_CLASSES, sem=SEM, seed=0):
    """(C, sem) unit class embeddings and the (1, sem) background vector."""
    b = np.random.RandomState(seed).randn(c, sem).astype(np.float32)
    return (b / np.linalg.norm(b, axis=1, keepdims=True),
            np.ones((1, sem), np.float32) / np.sqrt(sem))


def text_kwargs() -> dict:
    """run_text_train_student.sh's head on the tiny detector."""
    embed, bg = text_bank()
    return dict(roi_heads_name="TextRes5ROIHeads", class_embed=embed,
                bg_embed=bg, distill_l2=True, distill_kl=True, kl_temp=5.0)


def tiny_batch(n=2, seed=7, max_gt=8):
    """``n`` images (every other one padded to 96x128) with 1-6 GT boxes
    each, so the images sample different numbers of valid ROIs: numpy
    arrays of the global batch."""
    rng = np.random.RandomState(seed)
    canvas = rng.uniform(0, 255, (n, H, W, 3)).astype(np.float32)
    hw = np.array([[H, W]] * n, np.int32)
    hw[1::2] = (96, 128)
    canvas[1::2, 96:] = 0.0
    canvas[1::2, :, 128:] = 0.0
    boxes = np.zeros((n, max_gt, 4), np.float32)
    classes = np.zeros((n, max_gt), np.int32)
    valid = np.zeros((n, max_gt), bool)
    for i in range(n):
        ih, iw = hw[i]
        g = 1 + (5 * i) % 6
        x1, y1 = rng.uniform(0, iw - 40, g), rng.uniform(0, ih - 40, g)
        bw, bh = rng.uniform(16, 60, g), rng.uniform(16, 60, g)
        boxes[i, :g] = np.stack([x1, y1, np.minimum(x1 + bw, iw),
                                 np.minimum(y1 + bh, ih)], axis=1)
        classes[i, :g] = rng.randint(0, NUM_CLASSES, g)
        valid[i, :g] = True
    return dict(canvas=canvas, hw=hw, orig=hw * 2 + 3, boxes=boxes,
                classes=classes, valid=valid)


def _tensors(batch):
    from ..structures import GTInstances, ImageBatch

    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return (ImageBatch(t["canvas"], t["hw"], t["orig"]),
            GTInstances(t["boxes"], t["classes"], t["valid"]))


def _build(spec):
    from ..checkpoint import init_weights
    from ..models import GeneralizedRCNN

    model = GeneralizedRCNN(**spec["kwargs"])
    if spec.get("state") is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in spec["state"].items()})
    else:
        init_weights(model, torch.Generator().manual_seed(0))
    return model.train()


def _full(t):
    """A tensor or an FSDP2 shard as a whole numpy array (a gather for a
    shard: every rank calls it)."""
    from ..parallel import full_tensor

    return full_tensor(t).detach().cpu().numpy()


def _local_numel(t) -> int:
    from torch.distributed.tensor import DTensor

    return (t.to_local() if isinstance(t, DTensor) else t).numel()


def step_worker(spec: dict) -> dict:
    """One rank's training steps (or the whole step with no process
    group). ``spec``: ``kwargs`` of ``GeneralizedRCNN``, ``state`` (numpy
    weights, or None for the seeded draw), ``batch`` (``tiny_batch``'s
    global batch), ``steps``, ``model_parallel``, ``seed``, ``device``
    ("cpu" by default; on CUDA float32 without TF32, cuDNN
    deterministic), ``clip`` (SOLVER.CLIP_GRADIENTS' (CLIP_TYPE,
    CLIP_VALUE), or None), and optionally
    ``resume`` (a checkpoint loaded before the steps, which then start at
    ``first_step``) and ``checkpoint`` (a path rank 0 writes after the
    steps). Returns the global losses of every step, the first step's full
    gradients, the valid ROIs this rank sampled, the local and whole sizes
    of the parameters and momentum buffers, and with ``checkpoint`` the
    full parameters and momentum and the largest difference between them
    and the same checkpoint loaded back into a fresh wrap."""
    from ..checkpoint import load_training_state, training_state
    from ..config import get_cfg
    from ..engine import make_train_step
    from ..parallel import get_rank, local_rows, wrap_model
    from ..solver import build_gradient_clipper

    torch.set_num_threads(1)
    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda":  # float32 as the reference step computes it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    cfg = get_cfg()
    cfg.TPU.MODEL_PARALLEL = int(spec.get("model_parallel", 1))
    if spec.get("clip"):
        clip = cfg.SOLVER.CLIP_GRADIENTS
        clip.ENABLED = True
        clip.CLIP_TYPE, clip.CLIP_VALUE = spec["clip"]

    def wrapped():
        model = _build(spec).to(device)
        forward = wrap_model(model, cfg)
        opt = torch.optim.SGD(model.parameters(), lr=spec.get("lr", 1e-3),
                              momentum=0.9)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
        return model, forward, opt, sched

    model, forward, opt, sched = wrapped()
    if spec.get("resume"):
        load_training_state(model, opt, torch.load(spec["resume"],
                                                   weights_only=True))
    rois = []
    model.roi_heads.register_forward_pre_hook(
        lambda m, a, kw: rois.append(int(kw["valid"].sum())),
        with_kwargs=True)
    step = make_train_step(model, opt, clip=build_gradient_clipper(cfg),
                           seed=spec.get("seed", 0), forward=forward)
    images, gt = (t.to(device) for t in local_rows(_tensors(spec["batch"])))
    losses, grads = [], None
    first = spec.get("first_step", 0)
    for s in range(first, first + spec.get("steps", 1)):
        out = step(images, gt, s)
        losses.append({k: float(v) for k, v in out.items()})
        if grads is None:
            grads = {n: _full(p.grad) for n, p in model.named_parameters()
                     if p.grad is not None}
    sizes = {n: (_local_numel(p), p.numel(),
                 _local_numel(opt.state[p]["momentum_buffer"]))
             for n, p in model.named_parameters() if p in opt.state}
    result = dict(rank=get_rank(), losses=losses, grads=grads,
                  roi_valid=rois[0], sizes=sizes)
    if spec.get("checkpoint"):
        state = training_state(model, opt, sched, 0)
        if get_rank() == 0:
            torch.save(state, spec["checkpoint"])
        from ..parallel import barrier

        barrier()
        loaded = torch.load(spec["checkpoint"], weights_only=True)
        model2, _, opt2, _ = wrapped()
        load_training_state(model2, opt2, loaded)
        diff = 0.0
        named2 = dict(model2.named_parameters())
        params, moms = {}, {}
        for n, p in model.named_parameters():
            params[n] = _full(p)
            moms[n] = _full(opt.state[p]["momentum_buffer"])
            m2 = opt2.state[named2[n]]["momentum_buffer"]
            diff = max(diff, float(np.abs(params[n]
                                          - _full(named2[n])).max()),
                       float(np.abs(moms[n] - _full(m2)).max()))
        result.update(params=params, momentum=moms, reload_max_diff=diff)
    return result


class _Recording:
    """An evaluator that keeps every image's detections, then delegates."""

    def __init__(self, inner):
        self.inner, self.dets = inner, {}

    def reset(self):
        self.inner.reset()

    def process_detections(self, image_ids, boxes, scores, classes, valid):
        for i, img in enumerate(image_ids):
            v = valid[i].astype(bool)
            self.dets[img] = (boxes[i][v], scores[i][v], classes[i][v])
        self.inner.process_detections(image_ids, boxes, scores, classes,
                                      valid)

    def evaluate(self):
        return self.inner.evaluate()


def eval_worker(spec: dict) -> dict:
    """One rank's share of the evaluation of ``EVAL_SET`` under
    ``spec["datasets"]`` at ``spec["batch_size"]``: the tiny detector of
    ``EVAL_OPTS`` with seeded weights. Returns the metrics, every image's
    detections, and the image ids this rank decoded."""
    from ..cli import build_evaluator
    from ..checkpoint import init_weights
    from ..config import get_cfg
    from ..data import build_detection_test_loader, register_all
    from ..data.mapper import DatasetMapper
    from ..evaluation import inference_on_dataset
    from ..models import build_model
    from ..parallel import get_rank, get_world_size

    torch.set_num_threads(1)
    register_all(spec["datasets"])
    cfg = get_cfg()
    cfg.merge_from_file(BASE1)
    cfg.merge_from_list(EVAL_OPTS)
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    decoded = []
    call = DatasetMapper.__call__

    def recording(self, record, *args, **kwargs):
        decoded.append(record["image_id"])
        return call(self, record, *args, **kwargs)

    DatasetMapper.__call__ = recording
    try:
        loader = build_detection_test_loader(
            cfg, EVAL_SET, batch_size=spec["batch_size"],
            shard=(get_rank(), get_world_size()))
        evaluator = _Recording(build_evaluator(cfg, EVAL_SET,
                                               spec["out_dir"]))
        results = inference_on_dataset(model.eval(), loader, evaluator)
    finally:
        DatasetMapper.__call__ = call
    return dict(rank=get_rank(), results=results, dets=evaluator.dets,
                decoded=sorted(set(decoded)))


def gather_worker(spec: dict) -> dict:
    """``parallel.all_gather_with_grad`` on ``spec["device"]``: rank r
    gathers rows filled with r + 1 and back-propagates the loss
    sum(gathered * (r + 1)); returns the gathered rows and this rank's
    gradient (every rank's rows get sum over ranks of (r + 1))."""
    from ..parallel import all_gather_with_grad, get_rank

    r = get_rank()
    x = torch.full((3, 4), float(r + 1), device=spec["device"],
                   requires_grad=True)
    y = all_gather_with_grad(x)
    (y * (r + 1)).sum().backward()
    return dict(rank=r, gathered=y.detach().cpu().numpy(),
                grad=x.grad.cpu().numpy())


WORKERS = {"step": step_worker, "eval": eval_worker,
           "gather": gather_worker}


def tasks_worker(tasks) -> list:
    """``[(kind, spec), ...]`` -> each ``WORKERS[kind](spec)`` in turn, in
    one rank (one spawn serves every check)."""
    return [WORKERS[kind](spec) for kind, spec in tasks]


def run_ranks(tasks, ranks: int, workdir: str, timeout: float = 120.0):
    """``tasks_worker(tasks)`` on ``ranks`` spawned CPU ranks over gloo,
    joined through a file store under ``workdir``; returns, for each task,
    the ranks' results in rank order. Ranks still running after
    ``timeout`` seconds are killed and ``TimeoutError`` raised."""
    from ..engine.launch import launch

    store = os.path.join(tempfile.mkdtemp(dir=workdir), "store")
    by_rank = launch(tasks_worker, ranks, dist_url=f"file://{store}",
                     args=(tasks,), backend="gloo",
                     devices=["cpu"] * ranks, timeout=timeout)
    return [list(r) for r in zip(*by_rank)]


def compare_steps(got: dict, ref: dict, label: str,
                  loss_rtol=LOSS_RTOL, grad_tol=GRAD_TOL) -> dict:
    """Raise unless ``got``'s losses (every step) and first-step gradients
    are ``ref``'s within the tolerances; returns the worst differences."""
    worst_loss, worst_grad = 0.0, 0.0
    for s, (a, b) in enumerate(zip(got["losses"], ref["losses"])):
        if set(a) != set(b):
            raise AssertionError(f"{label}: step {s} losses {sorted(a)} "
                                 f"against {sorted(b)}")
        for k in b:
            err = abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
            worst_loss = max(worst_loss, err if abs(b[k]) > 1e-7 else 0.0)
            if abs(a[k] - b[k]) > loss_rtol * abs(b[k]) + 1e-7:
                raise AssertionError(f"{label}: step {s} {k} {a[k]} "
                                     f"against {b[k]}")
    if set(got["grads"]) != set(ref["grads"]):
        raise AssertionError(f"{label}: gradients of different parameters")
    for n, want in ref["grads"].items():
        scale = float(np.abs(want).max())
        err = float(np.abs(got["grads"][n] - want).max())
        worst_grad = max(worst_grad, err / max(scale, 1e-30))
        if err > grad_tol * scale + 1e-12:
            raise AssertionError(f"{label}: gradient of {n} off by {err} of "
                                 f"its max {scale}")
    return dict(loss_rel=worst_loss, grad_rel=worst_grad)


def set_match(a, b, iou_min=0.99, score_tol=1e-4) -> None:
    """Every detection (boxes, scores, classes) of ``a`` has one in ``b``
    with its class, IoU >= iou_min and a score within score_tol, and the
    counts agree."""
    (ab, as_, ac), (bb, bs, bc) = a, b
    if len(ab) != len(bb):
        raise AssertionError(f"{len(ab)} detections against {len(bb)}")
    if not len(ab):
        return
    x1 = np.maximum(ab[:, None, 0], bb[None, :, 0])
    y1 = np.maximum(ab[:, None, 1], bb[None, :, 1])
    x2 = np.minimum(ab[:, None, 2], bb[None, :, 2])
    y2 = np.minimum(ab[:, None, 3], bb[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (ab[:, 2] - ab[:, 0]) * (ab[:, 3] - ab[:, 1])
    area_b = (bb[:, 2] - bb[:, 0]) * (bb[:, 3] - bb[:, 1])
    iou = inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                             1e-12)
    ok = ((iou >= iou_min) & (ac[:, None] == bc[None, :])
          & (np.abs(as_[:, None] - bs[None, :]) <= score_tol))
    if not ok.any(axis=1).all():
        raise AssertionError(f"{(~ok.any(axis=1)).sum()} detections "
                             "unmatched")


def check_steps(ref, got, label) -> dict:
    """Every rank's result ``got`` against one process's ``ref``; the
    ranks' valid ROI counts must differ."""
    worst = {}
    for g in got:
        worst = compare_steps(g, ref, f"{label} rank {g['rank']}")
    counts = [g["roi_valid"] for g in got]
    if len(set(counts)) < 2:
        raise AssertionError(f"{label}: the ranks sampled {counts} valid "
                             "ROIs: the normalizers go untested")
    return dict(worst, roi_valid=counts)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--workdir", default=None)
    args = p.parse_args(argv)
    if args.ranks < 2 or args.ranks % 2:
        raise SystemExit("--ranks must be even and at least 2")
    with tempfile.TemporaryDirectory(dir=args.workdir) as work:
        from ..tools.make_synthetic_voc import make_voc

        flag = dict(TINY, **SAMPLED)
        batch = tiny_batch(args.ranks)
        dp = dict(kwargs=flag, state=None, batch=batch, steps=2)
        text = dict(dp, kwargs=dict(flag, **text_kwargs()), steps=1)
        # the ZeRO check clips each gradient's values, as DP then does
        clipped = dict(dp, clip=("value", 1e-3))
        ckpt = os.path.join(work, "zero.pth")
        zero = dict(clipped, model_parallel=2, checkpoint=ckpt)
        datasets = os.path.join(work, "voc")
        make_voc(datasets, images=6)
        ev = dict(datasets=datasets, batch_size=2,
                  out_dir=os.path.join(work, "eval"))
        tasks = [("step", dp), ("step", text), ("step", zero), ("eval", ev),
                 ("step", clipped)]
        refs = [WORKERS[k](dict(spec, model_parallel=1,
                                checkpoint=None)) for k, spec in tasks]
        got = run_ranks(tasks, args.ranks, work)

        r = check_steps(refs[0], got[0], "DP step")
        print(f"DP step, {args.ranks} ranks: 2 steps' losses and the "
              f"gradients equal one process's (worst loss "
              f"{r['loss_rel']:.2e}, gradient {r['grad_rel']:.2e}); valid "
              f"ROIs by rank {r['roi_valid']}", flush=True)
        r = check_steps(refs[1], got[1], "text step")
        print(f"text student step, {args.ranks} ranks: equal one process's "
              f"(worst loss {r['loss_rel']:.2e}, gradient "
              f"{r['grad_rel']:.2e}); valid ROIs by rank {r['roi_valid']}",
              flush=True)
        for z in got[2]:
            compare_steps(z, got[4][0], f"ZeRO rank {z['rank']}")
            if z["reload_max_diff"] != 0.0:
                raise AssertionError("ZeRO checkpoint reloaded off by "
                                     f"{z['reload_max_diff']}")
        local = sum(v[0] for v in got[2][0]["sizes"].values())
        whole = sum(v[1] for v in got[2][0]["sizes"].values())
        mom = sum(v[2] for v in got[2][0]["sizes"].values())
        if not local < 0.6 * whole:
            raise AssertionError(f"ZeRO: {local} of {whole} parameter "
                                 "elements on rank 0")
        state = torch.load(ckpt, weights_only=True)
        one = _build(dict(kwargs=flag))
        one.load_state_dict(state["model"])
        for n, p in one.named_parameters():
            if not np.array_equal(p.detach().numpy(),
                                  got[2][0]["params"][n]):
                raise AssertionError(f"ZeRO checkpoint: {n} differs")
        print(f"ZeRO step, mesh ({args.ranks // 2}, 2), gradients clipped "
              f"by value: 2 steps' losses and the gradients equal DP's; "
              f"rank 0 holds {local} of {whole} "
              f"parameter elements and {mom} momentum elements; its "
              "checkpoint reloads sharded exactly and loads in one process",
              flush=True)
        ref = refs[3]
        for g in got[3]:
            if g["results"] != ref["results"]:
                raise AssertionError(f"rank {g['rank']} metrics "
                                     f"{g['results']} against {ref['results']}")
            if set(g["dets"]) != set(ref["dets"]):
                raise AssertionError("sharded evaluation saw other images")
            for img, d in ref["dets"].items():
                set_match(g["dets"][img], d)
        decoded = [g["decoded"] for g in got[3]]
        if set().union(*map(set, decoded)) != set(ref["decoded"]) or sum(
                map(len, decoded)) != len(ref["decoded"]):
            raise AssertionError(f"decoded by rank {decoded}")
        print(f"sharded evaluation, {args.ranks} ranks: metrics equal one "
              f"process's on every rank ({ref['results']['bbox']['AP50']:.4f}"
              f" AP50), detections set-matched, images decoded by rank "
              f"{[len(d) for d in decoded]}", flush=True)
    print("dryrun_multidevice: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
