"""The port's StandardROIHeads (``models/box_head.py``) against the JAX
package's, on the CPU, float32.

The tiny detector of tests/test_torch_train_model.py with StandardROIHeads
(NUM_FC 2, with and without a conv in each tower) in place of the res5
head, on the JAX package's perturbed params carried across by
``state_dict_from_jax_params`` (which permutes the first fc's input order:
flax flattens (P, P, C), torch (C, P, P)). Compared: inference detections
(as sets: classes equal, boxes IoU >= 0.999, scores within 1e-4), the
training losses (relative 1e-5) and the gradient of every parameter,
within 1e-4 of its largest value, the first fc of both towers included;
and ``build_model``'s check of an empty tower.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    GeneralizedRCNN as JaxRCNN,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    GTInstances as JaxGT,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    init_weights,
    state_dict_from_jax_params,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    GeneralizedRCNN,
    build_model,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models.box_head import (
    StandardROIHeads,
)
from tests.test_full_network_oracle import _perturb
from tests.test_torch_model import (
    inputs,
    jax_images,
    match_detections,
    port_images,
)
from tests.test_torch_train_model import (
    gt_arrays,
    port_gt,
    total_loss,
    train_kwargs,
)

TOWERS = [(0, 32, 2, 64), (1, 32, 2, 64)]
_CACHE = {}


def pair(convfc):
    if convfc not in _CACHE:
        kw = dict(train_kwargs(), cls_dropout=False,
                  roi_heads_name="StandardROIHeads", box_convfc=convfc)
        jmodel = JaxRCNN(**kw)
        canvas, hw, orig = inputs(False)
        variables = jmodel.init({"params": jax.random.PRNGKey(0)},
                                jax_images(canvas, hw, orig), train=False)
        params = _perturb(jax.device_get(variables["params"]))
        port = GeneralizedRCNN(**kw)
        port.load_state_dict(state_dict_from_jax_params(params))
        _CACHE[convfc] = (jmodel, params, port)
    return _CACHE[convfc]


@pytest.mark.parametrize("convfc", TOWERS)
@pytest.mark.parametrize("padded", [False, True])
def test_standard_heads_inference_matches_jax(convfc, padded):
    jmodel, params, port = pair(convfc)
    canvas, hw, orig = inputs(padded)
    det = jax.device_get(jax.jit(lambda p, im: jmodel.apply(
        {"params": p}, im, train=False))(params, jax_images(canvas, hw, orig)))
    with torch.no_grad():
        tdet = port.eval().forward_inference(port_images(canvas, hw, orig))
    assert int(np.asarray(det.valid).sum()) > 10
    for i in range(2):
        v, tv = np.asarray(det.valid[i]), tdet.valid[i].numpy()
        match_detections(
            (tdet.boxes[i].numpy()[tv], tdet.scores[i].numpy()[tv],
             tdet.classes[i].numpy()[tv]),
            (np.asarray(det.boxes[i])[v], np.asarray(det.scores[i])[v],
             np.asarray(det.classes[i])[v]),
            iou_min=0.999, score_tol=1e-4)


@pytest.mark.parametrize("convfc", TOWERS)
def test_standard_heads_train_losses_and_gradients_match_jax(convfc):
    jmodel, params, port = pair(convfc)
    canvas, hw, orig = inputs(True)
    gb, gc, gv = gt_arrays(hw)
    jgt = JaxGT(jnp.asarray(gb), jnp.asarray(gc), jnp.asarray(gv))

    def loss_fn(p):
        losses = jmodel.apply(
            {"params": p}, jax_images(canvas, hw, orig), jgt, train=True,
            rngs={"sampling": jax.random.PRNGKey(1),
                  "dropout": jax.random.PRNGKey(2)})
        return total_loss(losses), losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    jl = jax.device_get(jl)

    port.train().zero_grad(set_to_none=True)
    losses = port.forward_train(port_images(canvas, hw, orig),
                                port_gt(gb, gc, gv),
                                torch.Generator().manual_seed(0))
    total_loss(losses).backward()
    assert set(losses) == set(jl)
    for k in jl:
        np.testing.assert_allclose(losses[k].item(), float(jl[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert losses["loss_box_reg"].item() > 0

    # the gradient tree goes through the weights' own conversion, so the
    # first fc's gradient is permuted as its weight is
    ref = state_dict_from_jax_params(jax.device_get(jg))
    named = dict(port.named_parameters())
    used = [n for n, p in named.items() if p.grad is not None]
    # the box tower's cls_score and the cls tower's bbox_pred are unused,
    # as in the JAX module (their gradients are zero there)
    assert sorted(set(named) - set(used)) == [
        "roi_heads.box_predictor.cls_score.bias",
        "roi_heads.box_predictor.cls_score.weight",
        "roi_heads.cls_predictor.bbox_pred.bias",
        "roi_heads.cls_predictor.bbox_pred.weight"]
    for name in ("roi_heads.box_head.fc1.weight",
                 "roi_heads.cls_head.fc1.weight", "backbone.res4.0.conv2.weight"):
        assert float(named[name].grad.abs().max()) > 0, name
    for name in used:
        want = ref[name].numpy()
        np.testing.assert_allclose(
            named[name].grad.numpy(), want, rtol=0,
            atol=1e-4 * float(np.abs(want).max()), err_msg=name)
    for name in set(named) - set(used):
        assert not ref[name].abs().max().item()


def test_empty_tower_is_refused():
    with pytest.raises(ValueError, match="NUM_CONV \\+ NUM_FC > 0"):
        StandardROIHeads(num_classes=5, in_channels=64, num_conv=0, num_fc=0)
    cfg = get_cfg()
    cfg.MODEL.ROI_HEADS.NAME = "StandardROIHeads"
    cfg.MODEL.ROI_BOX_HEAD.NUM_FC = 0
    with pytest.raises(ValueError, match="NUM_CONV \\+ NUM_FC > 0"):
        build_model(cfg)


def test_build_model_reads_the_towers_and_draws_flax_initialisers():
    cfg = get_cfg()
    cfg.MODEL.RESNETS.DEPTH = 14
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 8
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 16
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 4
    cfg.MODEL.ROI_HEADS.NAME = "StandardROIHeads"
    cfg.MODEL.ROI_BOX_HEAD.NUM_CONV = 1
    cfg.MODEL.ROI_BOX_HEAD.NUM_FC = 2
    model = init_weights(build_model(cfg), torch.Generator().manual_seed(0))
    state = model.state_dict()
    assert tuple(state["roi_heads.box_head.conv1.weight"].shape) == (
        256, 64, 3, 3)
    assert tuple(state["roi_heads.cls_head.fc1.weight"].shape) == (
        1024, 256 * 7 * 7)
    assert tuple(state["roi_heads.cls_predictor.cls_score.weight"].shape) == (
        cfg.MODEL.ROI_HEADS.NUM_CLASSES + 1, 1024)
    # lecun normal: variance 1 / fan_in
    w = state["roi_heads.box_head.conv1.weight"]
    assert abs(float(w.std()) ** 2 * 64 * 9 - 1.0) < 0.1
    assert not any(k.startswith("roi_heads.res5") for k in state)
