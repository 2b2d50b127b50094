"""The port's bf16 forward_inference and predict_batch held to the JAX
package's by the bf16 rule (``…_torch/tools/bf16_parity.py``); split
from tests/test_torch_bf16_model.py so that each file is a small share
of one xdist worker."""

import pytest

import jax
import jax.numpy as jnp
import torch

from fewshotobjectdetection_imporove_via_text_feature_tpu.config import (
    get_cfg as jax_get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.engine.predictor import (
    DefaultPredictor as JaxPredictor,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    build_model as jax_build_model,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    ImageBatch as JaxImageBatch,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    DefaultPredictor,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    GeneralizedRCNN,
    fast_rcnn_inference,
    select_top_proposals,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
    ImageBatch,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    bf16_parity as cases,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools.bf16_parity import (
    image_batch,
    seed_weights,
    tiny_inputs,
)
from tests.test_torch_bf16_model import (  # noqa: F401
    _infer,
    flagship,
    jax_images,
    jax_params_like,
    rule3,
    shaped,
)


@pytest.mark.parametrize("stride_in_1x1,padded,heads", [
    (True, False, "Res5ROIHeads"), (True, True, "Res5ROIHeads"),
    (False, True, "Res5ROIHeads"), (True, True, "StandardROIHeads")])
def test_bf16_forward_inference_holds_to_jax(stride_in_1x1, padded, heads):
    """StandardROIHeads with a conv and two fcs: its bf16 tower adds each
    bias after the product, as flax's layers do."""
    extra = {} if heads == "Res5ROIHeads" else dict(
        roi_heads_name=heads, box_convfc=(1, 32, 2, 64))
    rmodel, jmodel, params, port = flagship(stride_in_1x1=stride_in_1x1,
                                            **extra)
    images = tiny_inputs(padded)
    _infer(rmodel, jmodel, params, port, jax_images(*images),
           image_batch(*images))


def test_bf16_predict_batch_holds_to_jax():
    """``DefaultPredictor.predict_batch`` in bf16 against the JAX package's
    predictors in float32 and bf16 on the same params and BGR images
    (three bucket shapes, one repeated), in original coordinates."""
    jcfg = {dt: cases.predictor_cfg(dt, jax_get_cfg())
            for dt in ("float32", "bfloat16")}
    cfg = cases.predictor_cfg("bfloat16")
    t = DefaultPredictor(cfg, device="cpu")
    assert t.model.dtype == torch.bfloat16
    seed_weights(t.model)
    h, w = cfg.TPU.IMAGE_BUCKETS[0]
    shapes = shaped(jax_build_model(jcfg["float32"]), JaxImageBatch(
        image=jnp.zeros((1, h, w, 3)), hw=jnp.asarray([[h, w]]),
        orig_hw=jnp.asarray([[h, w]])), train=False)
    params = jax_params_like(shapes, t.model)
    r, j = (JaxPredictor(jcfg[dt], params=params)
            for dt in ("float32", "bfloat16"))
    images = cases.predictor_images()

    def dets(outs):
        return [(o["boxes"], o["classes"]) for o in outs]

    rule3(dets(t.predict_batch(images)), dets(j.predict_batch(images)),
          dets(r.predict_batch(images)))
