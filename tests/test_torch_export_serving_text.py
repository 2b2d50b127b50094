"""The text family's export serves what its eager predictor serves
(``…_torch/engine/export.py``); split from
tests/test_torch_export_serving.py so that each file is a small share of
one xdist worker."""

import numpy as np

from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    DefaultPredictor,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine.export import (
    ServingPredictor,
)
from tests.test_torch_export_serving import (  # noqa: F401
    _image,
    artifact,
    export_to,
    tiny_cfg,
)


def test_text_family_export_serves(tmp_path):
    cfg = tiny_cfg([
        "MODEL.ROI_HEADS.NUM_CLASSES", "15",
        "MODEL.ROI_HEADS.NAME", "TextRes5ROIHeads",
        "MODEL.ROI_HEADS.STUDENT_TRAINING", "True",
        "MODEL.ADDITION.NAME", "glove",
        "DATASETS.TRAIN", "('voc_2007_trainval_base1',)",
    ])
    pred = DefaultPredictor(cfg, device="cpu")
    path = str(tmp_path / "text.fsodtf-torch")
    meta, _ = export_to(path, cfg, pred)
    assert len(meta["class_names"]) == 15
    serving = ServingPredictor(path, device="cpu")
    img = _image((100, 150), 1)
    a, b = pred(img), serving(img)
    for k in ("boxes", "scores", "classes"):
        np.testing.assert_array_equal(a[k], b[k])
