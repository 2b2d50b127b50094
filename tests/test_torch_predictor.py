"""The port's DefaultPredictor(cfg, device="cpu") against the JAX
DefaultPredictor on the same params, at a tiny cfg: same BGR images in,
the same detections out (compared as sets, in original coordinates)."""

import numpy as np
import pytest

import jax

from fewshotobjectdetection_imporove_via_text_feature_tpu.config import (
    get_cfg as jax_get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.engine.predictor import (
    DefaultPredictor as JaxPredictor,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    state_dict_from_jax_params,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    DefaultPredictor,
)
from tests.test_full_network_oracle import _perturb
from tests.test_torch_model import match_detections


def _tiny(cfg):
    cfg.MODEL.WEIGHTS = ""
    cfg.MODEL.RESNETS.DEPTH = 14
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 8
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 16
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 4
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 256
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 64
    cfg.TPU.IMAGE_BUCKETS = ((192, 256),)
    cfg.TPU.MAX_DETECTIONS_PRE_NMS = 256
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.INPUT.MIN_SIZE_TEST = 192
    cfg.INPUT.MAX_SIZE_TEST = 256
    return cfg


@pytest.fixture(scope="module")
def predictors():
    jpred = JaxPredictor(_tiny(jax_get_cfg()))
    params = _perturb(jax.device_get(jpred.params))
    jpred.params = params
    port = DefaultPredictor(_tiny(get_cfg()), device="cpu",
                            state_dict=state_dict_from_jax_params(params))
    return jpred, port


def _images():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 255, (230, 310, 3), dtype=np.uint8),
            rng.randint(0, 255, (192, 256, 3), dtype=np.uint8),
            rng.randint(0, 255, (300, 200, 3), dtype=np.uint8)]


def _as_tuple(out):
    return out["boxes"], out["scores"], out["classes"]


def test_predictor_call_matches_jax(predictors):
    jpred, port = predictors
    for image in _images():
        ours, ref = port(image), jpred(image)
        assert set(ours) == {"boxes", "scores", "classes"}
        assert len(ref["boxes"]) > 5
        match_detections(_as_tuple(ours), _as_tuple(ref))
        # original-image coordinates
        assert ours["boxes"][:, 2].max() <= image.shape[1] + 1e-3
        assert ours["boxes"][:, 3].max() <= image.shape[0] + 1e-3


def test_predict_batch_matches_jax(predictors):
    jpred, port = predictors
    images = _images() + _images()[:1]
    ours, ref = port.predict_batch(images), jpred.predict_batch(images)
    assert len(ours) == len(images)
    for o, r in zip(ours, ref):
        match_detections(_as_tuple(o), _as_tuple(r))


def test_predictor_bfloat16_compute_dtype_runs(predictors):
    """COMPUTE_DTYPE bfloat16 (the default): bf16 backbone and res5, f32
    RPN outputs, pooled means and predictor; detections finite with
    float32 scores, and held to the JAX package's bf16 predictor on the
    same params by rule 3 of tests/test_torch_bf16_model.py: of the valid
    detections, the port's bf16 run matches (IoU > 0.9, same class) at
    least as many in the JAX bf16 run as that run matches in the JAX
    float32 run, over the three images."""
    from tests.test_torch_bf16_model import rule3

    jpred32, port32 = predictors
    cfg = _tiny(get_cfg())
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    port16 = DefaultPredictor(cfg, device="cpu",
                              state_dict=port32.model.state_dict())
    jcfg = _tiny(jax_get_cfg())
    jcfg.TPU.COMPUTE_DTYPE = "bfloat16"
    jpred16 = JaxPredictor(jcfg, params=jpred32.params)
    outs = {name: [pred(image) for image in _images()] for name, pred in
            (("T", port16), ("J", jpred16), ("R", jpred32))}
    for out16 in outs["T"]:
        assert np.isfinite(out16["boxes"]).all()
        assert np.isfinite(out16["scores"]).all()
        assert out16["scores"].dtype == np.float32
    rule3(*([(o["boxes"], o["classes"]) for o in outs[name]]
            for name in ("T", "J", "R")))
