"""The serving artifact at batch 8 and the text family's export
(``…_torch/engine/export.py``); split from
tests/test_torch_export_serving.py so that each file is a small share of
one xdist worker."""

from fewshotobjectdetection_imporove_via_text_feature_torch.engine.export import (
    ServingPredictor,
)
from test_server import assert_detections_setmatch
from tests.test_torch_export_serving import (  # noqa: F401
    _image,
    artifact,
    export_to,
    tiny_cfg,
)


def test_multibatch_artifact_predict_batch(artifact, tmp_path):
    cfg, pred, _, _ = artifact
    p = str(tmp_path / "mb.fsodtf-torch")
    meta, programs = export_to(p, cfg, pred, batch=(1, 4))
    assert meta["batches"] == [1, 4]
    assert len(programs) == 4  # 2 buckets x 2 batch sizes
    serving = ServingPredictor(p, device="cpu")
    imgs = [_image(hw, 9 + i) for i, hw in
            enumerate([(100, 150), (150, 100), (90, 140)])]
    outs = serving.predict_batch(imgs)
    for im, out in zip(imgs, outs):
        assert_detections_setmatch(out, serving(im))
    # the same grouping as the live predictor's batches
    for out, ref in zip(outs, pred.predict_batch(imgs)):
        assert_detections_setmatch(out, ref)


