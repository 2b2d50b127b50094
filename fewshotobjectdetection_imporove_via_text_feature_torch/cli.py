"""Command line of the PyTorch package, counterpart of the JAX package's
``cli.py`` (ref main.py:36-132): train, then evaluate, or evaluate only.

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.cli \\
        --config-file configs/voc/defrcn_det_r101_base1.yaml \\
        --opts MODEL.WEIGHTS "" OUTPUT_DIR out/base1
    python -m fewshotobjectdetection_imporove_via_text_feature_torch.cli \\
        --config-file ... --eval-only --opts MODEL.WEIGHTS out/model_final.pth

It runs on ``MODEL.DEVICE`` ("cuda" by default; ``MODEL.DEVICE cpu`` for
the CPU) and raises when CUDA is absent. Datasets are read under
``$FSODTF_DATASETS`` (default ``datasets``). OUTPUT_DIR/log.txt gets the
whole log, ending in the "copypaste:" lines that
``tools/extract_results.py`` scrapes. ``MODEL.WEIGHTS ""`` starts from
weights drawn from the seed.

``TEST.PCB_ENABLE True`` rescores the detections with PCB
(``evaluation/pcb.py``).

With ``FSODTF_LAUNCH_COUNTS=FILE`` in the environment, the process appends
its launches of the hand-written kernels to FILE at exit, as one JSON line
(``{"argv": [...], "greedy_nms": n, "roi_align_v2_fwd": n,
"roi_align_v2_bwd": n}``): the counts of a run driven as a subprocess, as
``chip_smoke.py`` drives the held-out gate.

More than one device, as the reference launches it:

    python -m ...cli --num-gpus 8 --config-file ...             # 8 cards
    python -m ...cli --num-gpus 8 --num-machines 2 --machine-rank R \
        --dist-url tcp://HOST0:PORT --config-file ...            # 2 machines
    python -m ...cli --num-gpus 2 --config-file ... --opts MODEL.DEVICE cpu

``engine/launch.py`` starts one process a device (``MODEL.DEVICE cpu``:
CPU ranks over gloo); training is data parallel (DDP), or ZeRO-3 with
``TPU.MODEL_PARALLEL`` M > 1 (FSDP2, one machine), on the losses of the
global batch; evaluation runs whole batches round-robin across the ranks
and every rank reports the same metrics. Rank 0 writes log.txt and the
checkpoints, the others OUTPUT_DIR/rank{r}/log.txt. ``TPU.SPATIAL_PARTITION``
is a serving option and is refused here, as in the JAX package.
"""

from __future__ import annotations

import argparse
import atexit
import json
import logging
import os
import platform
import sys

# evaluation batch: on an H100 80GB HBM3 at its 700 W limit, bf16 R-101
# on 500x375 images (the 800x1344 bucket), batch 32 gave 129.5 images/s
# against 119.7 at 16 and 96.4 at 8, at 5.13 GiB, over 20-95 timed batches
# (tools/eval_batch_sweep.py); a bucket group's last batch is padded with
# copies, which valid_count drops
EVAL_BATCH_SIZE = 32

logger = logging.getLogger("fsodtf_torch")


def default_argument_parser():
    parser = argparse.ArgumentParser(
        description="DeFRCN few-shot detection (PyTorch)")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--eval-iter", type=int, default=-1)
    # the reference's launch options: local ranks (one a device), machines
    parser.add_argument("--num-gpus", type=int, default=1)
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0)
    parser.add_argument("--dist-url", default="auto")
    parser.add_argument(
        "--opts", default=[], nargs=argparse.REMAINDER,
        help="Modify config options via 'KEY VALUE' pairs",
    )
    return parser


def check_cli_config(cfg, args=None) -> None:
    """Raise for an option this package does not run."""
    if args is not None and args.num_machines > 1 and \
            cfg.TPU.MODEL_PARALLEL > 1:
        raise ValueError("TPU.MODEL_PARALLEL > 1 runs on one machine only "
                         "(a run across machines is data parallel)")
    if cfg.TPU.SPATIAL_PARTITION > 1:
        # a serving option (DefaultPredictor), as in the JAX package:
        # evaluation and training would run unpartitioned without saying so
        raise ValueError(
            "TPU.SPATIAL_PARTITION applies to DefaultPredictor serving "
            "only; evaluation runs whole batches round-robin across the "
            "ranks")
    if cfg.TEST.PCB_ENABLE and cfg.TEST.PCB_MODELTYPE != "resnet":
        # PCB raises so too, after training: say it before
        raise NotImplementedError(
            f"TEST.PCB_MODELTYPE {cfg.TEST.PCB_MODELTYPE!r}: only 'resnet' "
            "exists (the reference raises the same way)")


def load_config(args):
    """cfg from the file and the overrides."""
    from .config import get_cfg

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    return cfg


def setup(args):
    """cfg from the file and the overrides; logging to stdout and
    OUTPUT_DIR/log.txt (OUTPUT_DIR/rank{r}/log.txt on ranks above 0)."""
    from .engine.trainer import rank_output_dir

    cfg = load_config(args)
    # EVAL_PERIOD as the reference (main.py:81-82) rewrites it; 0 (the
    # default) evaluates at the end
    if cfg.TEST.EVAL_PERIOD == 1000:
        cfg.TEST.EVAL_PERIOD = cfg.SOLVER.MAX_ITER // 3 + 100
    if cfg.TEST.EVAL_PERIOD == 0 and cfg.SOLVER.MAX_ITER > 0:
        cfg.TEST.EVAL_PERIOD = cfg.SOLVER.MAX_ITER
    check_cli_config(cfg, args)
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    if not any(getattr(h, "_fsodtf_torch", None) == "stdout"
               for h in root.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        sh._fsodtf_torch = "stdout"
        root.addHandler(sh)
    if cfg.OUTPUT_DIR:
        out = rank_output_dir(cfg)
        os.makedirs(out, exist_ok=True)
        path = os.path.abspath(os.path.join(out, "log.txt"))
        # one file handler per log.txt, however often setup runs in-process
        if not any(getattr(h, "_fsodtf_torch", None) == path
                   for h in root.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            fh._fsodtf_torch = path
            root.addHandler(fh)
    if not cfg.MUTE_HEADER:
        import torch

        logger.info("environment: python %s, torch %s, cuda %s, device %s",
                    platform.python_version(), torch.__version__,
                    torch.version.cuda, cfg.MODEL.DEVICE)
        logger.info("Running with full config:\n%s", cfg.dump())
    return cfg


def resolve_eval_iter_checkpoint(output_dir: str, eval_iter: int) -> str:
    """--eval-iter N -> OUTPUT_DIR's checkpoint of that iteration: a
    periodic checkpoint carries the 0-based iteration (model_0000999 for
    period 1000), so N and N-1 are both looked for, as this package's
    ``.pth`` or the JAX package's ``.ckpt``."""
    candidates = [
        os.path.join(output_dir, f"model_{i:07d}{ext}")
        for i in (eval_iter, eval_iter - 1)
        for ext in (".pth", ".ckpt")
        if i >= 0
    ]
    found = next((c for c in candidates if os.path.exists(c)), None)
    if found is None:
        raise FileNotFoundError(
            f"--eval-iter {eval_iter}: none of {candidates} exist")
    return found


def build_evaluator(cfg, dataset_name, output_dir):
    from .data import MetadataCatalog
    from .evaluation import COCOEvaluator, PascalVOCDetectionEvaluator

    etype = MetadataCatalog.get(dataset_name).get("evaluator_type")
    if etype == "pascal_voc":
        return PascalVOCDetectionEvaluator(dataset_name, output_dir)
    if etype == "coco":
        return COCOEvaluator(dataset_name, output_dir)
    raise NotImplementedError(f"no evaluator for {dataset_name} ({etype})")


def build_test_model(cfg):
    """The model of ``cfg`` on its device, in eval mode: weights drawn from
    seed 0, then MODEL.WEIGHTS (``.pkl``, ``.pth`` or a JAX ``.ckpt``)."""
    import torch

    from .checkpoint import init_weights, maybe_load_reference_weights
    from .engine.predictor import resolve_device
    from .models import build_model

    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    maybe_load_reference_weights(cfg.MODEL.WEIGHTS, model)
    return model.to(resolve_device(cfg)).eval()


def do_test(cfg, model=None):
    """Evaluate on every dataset of cfg.DATASETS.TEST, with PCB when
    TEST.PCB_ENABLE; prints the copypaste rows and exits 1 when
    TEST.EXPECTED_RESULTS fails. Under a process group each rank decodes
    and runs its round-robin share of the batches, and every rank returns
    the same results."""
    from .data import build_detection_test_loader
    from .evaluation import (
        inference_on_dataset,
        print_csv_format,
        verify_results,
    )
    from .parallel import get_rank, get_world_size

    check_cli_config(cfg)
    if model is None:
        model = build_test_model(cfg)
    pin = next(model.parameters()).is_cuda
    pcb = None
    if cfg.TEST.PCB_ENABLE:
        from .evaluation.pcb import PrototypicalCalibrationBlock

        pcb = PrototypicalCalibrationBlock(cfg)
    results = {}
    for dataset_name in cfg.DATASETS.TEST:
        loader = build_detection_test_loader(
            cfg, dataset_name, batch_size=EVAL_BATCH_SIZE, pin_memory=pin,
            shard=(get_rank(), get_world_size()))
        evaluator = build_evaluator(cfg, dataset_name, cfg.OUTPUT_DIR)
        res = inference_on_dataset(model, loader, evaluator, pcb=pcb,
                                   no_gt=cfg.TEST.NO_GT_EVAL)
        results[dataset_name] = res
        print_csv_format(res)
        if not verify_results(cfg, res):
            sys.exit(1)
    return results


def do_train(cfg, resume: bool = False):
    """Train on cfg.DATASETS.TRAIN, with the periodic evaluation hook;
    returns the ``Trainer``. Data parallel (or FSDP2) under a process
    group."""
    from .engine import Trainer
    from .engine.hooks import EvalHook

    trainer = Trainer(cfg)
    trainer.resume_or_load(resume=resume)
    if 0 < cfg.TEST.EVAL_PERIOD < cfg.SOLVER.MAX_ITER and cfg.DATASETS.TEST:
        trainer.hooks.append(EvalHook(
            cfg.TEST.EVAL_PERIOD, cfg.SOLVER.MAX_ITER, cfg.OUTPUT_DIR,
            lambda: do_test(cfg, model=trainer.inference_model())))
    trainer.train()
    return trainer


def _append_launch_counts(path, argv):
    """One JSON line of this process's kernel launches, appended to
    ``path``."""
    from .ops import nms_cuda, roi_align_cuda

    with open(path, "a") as f:
        f.write(json.dumps({
            "argv": argv,
            "greedy_nms": nms_cuda.nms_sorted_cuda.launches,
            "roi_align_v2_fwd": roi_align_cuda.roi_align_cuda.launches,
            "roi_align_v2_bwd": roi_align_cuda.roi_align_bwd_cuda.launches,
        }) + "\n")


def main(argv=None):
    """The command line. With ``--num-gpus`` or ``--num-machines`` above 1
    it runs on one process a device (``engine/launch.py``) and returns
    local rank 0's results."""
    if os.environ.get("FSODTF_LAUNCH_COUNTS"):
        atexit.register(_append_launch_counts,
                        os.environ["FSODTF_LAUNCH_COUNTS"],
                        list(sys.argv[1:] if argv is None else argv))
    args = default_argument_parser().parse_args(argv)
    if args.num_gpus * args.num_machines == 1:
        return run(args)
    from .engine.launch import launch

    device = load_config(args).MODEL.DEVICE
    if device == "cpu":
        devices = ["cpu"] * args.num_gpus
    else:
        import torch

        if args.num_gpus > torch.cuda.device_count():
            raise ValueError(
                f"--num-gpus {args.num_gpus}: {torch.cuda.device_count()} "
                "CUDA devices are visible")
        devices = [f"cuda:{i}" for i in range(args.num_gpus)]
    return launch(run, args.num_gpus, args.num_machines, args.machine_rank,
                  args.dist_url, args=(args,), devices=devices)[0]


def run(args):
    """Train and evaluate, or evaluate only, in this process (one rank of
    a launch, or the whole run)."""
    cfg = setup(args)

    from .data import register_all

    register_all(os.environ.get("FSODTF_DATASETS", "datasets"))
    if args.eval_only:
        if args.eval_iter >= 0:
            cfg.MODEL.WEIGHTS = resolve_eval_iter_checkpoint(
                cfg.OUTPUT_DIR, args.eval_iter)
        return do_test(cfg)
    trainer = do_train(cfg, resume=args.resume)
    if trainer.preempted:
        # SIGTERM: a resumable checkpoint was saved; no final evaluation
        return None
    if cfg.DATASETS.TEST:
        return do_test(cfg, model=trainer.inference_model())
    return None


if __name__ == "__main__":
    main()
