"""Serve detections over HTTP (``engine/server.py``), with the options of
the repository's ``tools/serve.py``. Two backends:

  --artifact X            a serving artifact of this package
                          (``ServingPredictor``; no model build, no config)
  --config-file ... [--opts]
                          a live model (``DefaultPredictor``; honours
                          MODEL.WEIGHTS)

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.serve \\
        --artifact model.fsodtf-torch --port 8080 --max-batch 8
    curl -s --data-binary @img.jpg localhost:8080/detect

Both run on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse


def build_predictor(args):
    """-> (predictor, meta, class names or None) of the parsed options."""
    if args.artifact:
        from ..engine.export import ServingPredictor

        predictor = ServingPredictor(args.artifact, device=args.device)
        meta = dict(predictor.meta)
        return predictor, meta, meta.pop("class_names", None)
    from ..config import get_cfg
    from ..engine.predictor import DefaultPredictor
    from ..utils.class_name import get_class_name

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    predictor = DefaultPredictor(cfg, device=args.device)
    meta = {"min_size_test": cfg.INPUT.MIN_SIZE_TEST,
            "max_size_test": cfg.INPUT.MAX_SIZE_TEST,
            "num_classes": cfg.MODEL.ROI_HEADS.NUM_CLASSES}
    try:
        class_names = list(get_class_name(cfg))
    except (ValueError, KeyError, IndexError):
        class_names = None
    return predictor, meta, class_names


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--artifact", help="serving artifact (a zip)")
    ap.add_argument("--config-file",
                    help="config for a live DefaultPredictor")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument(
        "--max-batch", type=int, default=1,
        help="dynamic batching: coalesce up to N concurrent requests into "
        "one predict_batch call (a live model, or an artifact exported "
        "with --batches)")
    ap.add_argument("--batch-window-ms", type=float, default=5.0,
                    help="how long the dispatcher waits to fill a batch")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: cuda, or MODEL.DEVICE)")
    ap.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    args = ap.parse_args(argv)
    if bool(args.artifact) == bool(args.config_file):
        ap.error("exactly one of --artifact / --config-file is required")

    from ..engine.server import DetectionServer

    predictor, meta, class_names = build_predictor(args)
    server = DetectionServer(
        predictor, host=args.host, port=args.port, class_names=class_names,
        meta=meta, max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms)
    print(f"serving on http://{server.host}:{server.port}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
