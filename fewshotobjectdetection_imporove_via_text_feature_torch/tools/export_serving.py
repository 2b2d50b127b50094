"""Export a checkpoint as a self-contained serving artifact
(``engine/export.py``), with the options of the repository's
``tools/export_serving.py``:

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.export_serving \\
        --config-file configs/voc/defrcn_det_r101_base1.yaml \\
        --output model.fsodtf-torch [--batches 1,8] [--device cuda] \\
        [--opts MODEL.WEIGHTS path ...]

``--device`` takes the place of the JAX tool's ``--platforms``: a
``torch.export`` program is traced for one device type and serves there
(``cuda`` by default, ``cpu`` when asked). Serve the artifact with
``tools/serve.py --artifact`` or in process::

    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.export \\
        import ServingPredictor
    dets = ServingPredictor("model.fsodtf-torch")(bgr_image)

The weights come as ``DefaultPredictor`` loads them: ``MODEL.WEIGHTS``
(``.pkl``, ``.pth``, ``.ckpt``), or the seeded initialisers without one.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument(
        "--batches", default="1",
        help="comma list of batch sizes to export programs for (e.g. "
        "'1,8'); more than batch 1 lets ServingPredictor.predict_batch and "
        "the HTTP server's --max-batch coalesce requests")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: MODEL.DEVICE)")
    ap.add_argument("--opts", default=[], nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    from ..config import get_cfg
    from ..engine.export import export_inference, save_serving_artifact
    from ..engine.predictor import DefaultPredictor

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    # the predictor's initialisation: seeded weights, then MODEL.WEIGHTS
    state = DefaultPredictor(cfg, device="cpu").model.state_dict()
    batches = [int(b) for b in args.batches.split(",") if b.strip()]
    meta, programs = export_inference(cfg, state, batch=batches,
                                      device=args.device)
    save_serving_artifact(args.output, meta, programs, state)
    mb = os.path.getsize(args.output) / 1e6
    print(f"wrote {args.output} ({mb:.1f} MB): {len(programs)} programs "
          f"(batches {meta['batches']}), device {meta['device']}")


if __name__ == "__main__":
    main()
