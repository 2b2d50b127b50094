"""A bf16 export serves what eager bf16 serves (the port's text family);
split from tests/test_torch_bf16_text.py so that each file is a small
share of one xdist worker."""

import numpy as np

import jax
import torch

from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    DefaultPredictor,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine.export import (
    ServingPredictor,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    bf16_parity as cases,
)
from tests.test_torch_export_serving import export_to


def test_bf16_export_serves_what_eager_bf16_serves(tmp_path):
    """One bf16 ``torch.export`` program (``engine/export.py``) through
    ``ServingPredictor``: bitwise the eager bf16 ``DefaultPredictor``."""
    cfg = cases.export_cfg("bfloat16")
    pred = DefaultPredictor(cfg, device="cpu")
    cases.seed_weights(pred.model)
    assert pred.model.dtype == torch.bfloat16
    path = str(tmp_path / "bf16.fsodtf-torch")
    export_to(path, cfg, pred)
    serving = ServingPredictor(path, device="cpu")
    for image in cases.export_images():
        a, b = pred(image), serving(image)
        assert len(a["boxes"]) > 10
        for k in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(a[k], b[k])
