"""Soak run of the port's CLI: a long training run that is preempted by
SIGTERM and resumed to the end.

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.soak_test \\
        [--iters 2000] [--preempt-at 900] [--ckpt-period 200] \\
        [--save-dir DIR] [--tiny] [--device cpu]

Counterpart of the repository's ``tools/soak_test.py``. It drives
``python -m fewshotobjectdetection_imporove_via_text_feature_torch.cli`` on
``configs/voc/defrcn_det_r101_base1.yaml`` (R-101 C4 at 800x1344, bf16,
batch 16, FREEZE_AT 2, asynchronous checkpoints; ``--tiny``: the depth-14
detector at 256x384 in float32, batch 2) over a learnable synthetic VOC
(``make_generalization_voc``: 16 + 8 train images), sends SIGTERM once
metrics.json passes ``--preempt-at``, then runs again with ``--resume``
to the end, and checks:

  * leg 1 exits 0 with a resumable checkpoint and no ``model_final.pth``;
  * leg 2 exits 0 and writes ``model_final.pth``;
  * metrics.json over both legs: iterations strictly increasing, no gap
    beyond the 20-iteration logging period, the last iteration reached,
    every loss finite;
  * the mean ``total_loss`` of the last tenth of the logged rows below
    that of the first tenth.

Prints the step time of the steady part (rows after the first quarter,
each a 20-step window of the Trainer's ``time_since_last_log``): median
and IQR, then one JSON line with the legs' outcome. The card is the
default device; ``--device cpu`` sets MODEL.DEVICE cpu and nothing else.

Reference budget semantics: configs/voc/defrcn_det_r101_base1.yaml:20-24.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from ..utils.events import read_metrics
from .make_generalization_voc import make_generalization_voc

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PORT = "fewshotobjectdetection_imporove_via_text_feature_torch"
CONFIG = os.path.join("configs", "voc", "defrcn_det_r101_base1.yaml")
LOG_PERIOD = 20


def _opts(args, out):
    common = [
        "MODEL.WEIGHTS", "",
        "SOLVER.MAX_ITER", str(args.iters),
        "SOLVER.STEPS", f"({args.iters * 3 // 4},{args.iters * 9 // 10})",
        "SOLVER.CHECKPOINT_PERIOD", str(args.ckpt_period),
        "TEST.EVAL_PERIOD", "0",
        "DATASETS.TEST", "()",
        "SEED", "13",
        "OUTPUT_DIR", out,
    ]
    if args.tiny:
        common += [
            "MODEL.RESNETS.DEPTH", "14",
            "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
            "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
            "MODEL.RESNETS.WIDTH_PER_GROUP", "4",
            "MODEL.BACKBONE.FREEZE_AT", "0",
            "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "256",
            "MODEL.RPN.POST_NMS_TOPK_TRAIN", "64",
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
            "TPU.IMAGE_BUCKETS", "((256,384),)",
            "TPU.MAX_GT", "10",
            "TPU.MAX_DETECTIONS_PRE_NMS", "128",
            "TPU.COMPUTE_DTYPE", "float32",
            "INPUT.MIN_SIZE_TRAIN", "(256,)",
            "INPUT.MAX_SIZE_TRAIN", "384",
            "SOLVER.IMS_PER_BATCH", "2",
            "SOLVER.BASE_LR", "0.001",
            "SOLVER.WARMUP_ITERS", "0",
        ]
    else:
        # the production profile: R-101 C4, 800x1344, bf16, asynchronous
        # checkpoints (the config's defaults), batch 16
        common += [
            "MODEL.BACKBONE.FREEZE_AT", "2",
            "SOLVER.IMS_PER_BATCH", "16",
            "SOLVER.BASE_LR", "0.02",
            "SOLVER.WARMUP_ITERS", "100",
        ]
    if args.device:
        common += ["MODEL.DEVICE", args.device]
    return common


def _quartiles(xs):
    xs = sorted(xs)
    return xs[len(xs) // 4], xs[len(xs) // 2], xs[3 * len(xs) // 4]


def steady_step_ms(rows):
    """(median, IQR) ms a step over the rows after the first quarter whose
    window is a whole logging period."""
    per = [1e3 * b["time_since_last_log"] / LOG_PERIOD
           for a, b in zip(rows, rows[1:])
           if b["iteration"] - a["iteration"] == LOG_PERIOD][len(rows) // 4:]
    if not per:
        return float("nan"), float("nan")
    q1, med, q3 = _quartiles(per)
    return med, q3 - q1


def check_metrics(rows, iters):
    """The merged metrics stream's asserts; returns the first and last
    tenth's mean total_loss."""
    its = [r["iteration"] for r in rows]
    if its != sorted(set(its)):
        raise AssertionError("iterations not strictly increasing")
    gaps = [b - a for a, b in zip(its, its[1:])]
    if max(gaps) > LOG_PERIOD:
        raise AssertionError(f"metric gap {max(gaps)} > logging period")
    if its[-1] != iters - 1:
        raise AssertionError(f"last iteration {its[-1]}, not {iters - 1}")
    for r in rows:
        for k, v in r.items():
            if (k.startswith("loss") or k == "total_loss") and \
                    not math.isfinite(v):
                raise AssertionError(f"non-finite {k} at {r['iteration']}: "
                                     f"{v}")
    dec = max(1, len(rows) // 10)
    first = sum(r["total_loss"] for r in rows[:dec]) / dec
    last = sum(r["total_loss"] for r in rows[-dec:]) / dec
    if not last < first:
        raise AssertionError(
            f"loss did not trend down: {first:.3f} -> {last:.3f}")
    return first, last


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--preempt-at", type=int, default=900)
    ap.add_argument("--ckpt-period", type=int, default=200)
    ap.add_argument("--save-dir",
                    default=os.path.join(tempfile.gettempdir(), "soak_test"))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None,
                    help="MODEL.DEVICE (default: the config's, cuda)")
    ap.add_argument("--timeout", type=int, default=5400,
                    help="per-leg wall timeout seconds")
    args = ap.parse_args(argv)

    save = args.save_dir
    shutil.rmtree(save, ignore_errors=True)
    os.makedirs(save, exist_ok=True)
    data_root = os.path.join(save, "datasets")
    # base1 trains on both years' trainval: 2012 must not be empty
    make_generalization_voc(data_root, train_2007=16, train_2012=8, val=4,
                            shots=(1,))
    out = os.path.join(save, "run")
    env = dict(os.environ, FSODTF_DATASETS=data_root)
    base_cmd = [sys.executable, "-m", f"{PORT}.cli", "--config-file",
                CONFIG]
    # --resume before --opts (--opts takes every later token)
    cmd = base_cmd + ["--opts", *_opts(args, out)]
    resume_cmd = base_cmd + ["--resume", "--opts", *_opts(args, out)]

    # ---- leg 1: train, SIGTERM once the metrics pass the preempt point
    print(f"[soak] leg 1: {args.iters} iters, SIGTERM at ~{args.preempt_at}",
          flush=True)
    t0 = time.time()
    with open(os.path.join(save, "leg1.log"), "w") as logf:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=logf,
                                stderr=subprocess.STDOUT)
        sent_at = None
        try:
            while proc.poll() is None:
                if time.time() - t0 > args.timeout:
                    raise AssertionError("[soak] leg 1 timed out")
                rows = read_metrics(out)
                if sent_at is None and rows and \
                        rows[-1]["iteration"] >= args.preempt_at:
                    sent_at = rows[-1]["iteration"]
                    print(f"[soak] SIGTERM at iter {sent_at} "
                          f"({time.time() - t0:.0f}s)", flush=True)
                    proc.send_signal(signal.SIGTERM)
                time.sleep(0.5)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    leg1_s = time.time() - t0
    if sent_at is None:
        raise AssertionError("training finished before the preemption point")
    if proc.returncode != 0:
        raise AssertionError(f"leg 1 rc={proc.returncode}")
    if os.path.exists(os.path.join(out, "model_final.pth")):
        raise AssertionError("a preempted run must not write model_final")
    ckpts = sorted(f for f in os.listdir(out) if f.startswith("model_0"))
    if not ckpts:
        raise AssertionError("no resumable checkpoint written")
    leg1_last = read_metrics(out)[-1]["iteration"]
    print(f"[soak] leg 1 done: preempted cleanly, last metric iter "
          f"{leg1_last}, ckpts={ckpts[-2:]}", flush=True)

    # ---- leg 2: resume to the end
    print("[soak] leg 2: --resume to completion", flush=True)
    t1 = time.time()
    with open(os.path.join(save, "leg2.log"), "w") as logf:
        rc = subprocess.run(resume_cmd, cwd=REPO, env=env, stdout=logf,
                            stderr=subprocess.STDOUT,
                            timeout=args.timeout).returncode
    leg2_s = time.time() - t1
    if rc != 0:
        raise AssertionError(f"leg 2 rc={rc}")
    if not os.path.exists(os.path.join(out, "model_final.pth")):
        raise AssertionError("leg 2 wrote no model_final.pth")

    rows = read_metrics(out)
    first, last = check_metrics(rows, args.iters)
    med, iqr = steady_step_ms(rows)
    print(f"[soak] PASSED: {args.iters} iters across a SIGTERM+resume, "
          f"loss {first:.3f} -> {last:.3f}, steady step time median "
          f"{med:.2f} ms (IQR {iqr:.2f}) = {med * LOG_PERIOD / 1e3:.2f}s/"
          f"{LOG_PERIOD}it, walls {leg1_s:.0f}s+{leg2_s:.0f}s", flush=True)
    result = dict(check="soak", iters=args.iters, tiny=args.tiny,
                  sigterm_at=sent_at, leg1_last_iter=leg1_last,
                  leg1_checkpoints=ckpts, rows=len(rows),
                  loss_first_decile=first, loss_last_decile=last,
                  step_ms_median=med, step_ms_iqr=iqr, leg1_s=leg1_s,
                  leg2_s=leg2_s)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
