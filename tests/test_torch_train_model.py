"""The port's training forward and backward against the JAX package's, on
the CPU, float32.

The tiny networks of tests/test_torch_model.py (depth 14 and 26, 128x160
canvas) with exhaustive sampling budgets (every labelled anchor and every
candidate ROI is sampled, as in tests/test_full_network_oracle.py), so that
the random draws of the two packages choose the same sets. Compared: every
loss (rtol 1e-4) and the gradient of every parameter the port has, each
within 1e-3 of its largest value, padded and unpadded, ``stride_in_1x1``
both ways. Then, on the port alone: the GDL contract (with lambda_rpn 0
the backbone's gradient is exactly lambda_rcnn times the ROI branch's),
``freeze_at`` 3 (no gradient below res4), and cls dropout.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    GeneralizedRCNN as JaxRCNN,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    GTInstances as JaxGT,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    state_dict_from_jax_params,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint.convert import (
    _to_torch_layout,
    jax_path_to_d2,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    FastRCNNOutputLayers,
    GeneralizedRCNN,
    cls_dropout,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
    GTInstances,
)
from tests.test_full_network_oracle import _perturb
from tests.test_torch_model import (
    NUM_CLASSES,
    inputs,
    jax_images,
    port_images,
    tiny_kwargs,
)

MAX_GT = 8
POST_NMS = 300
RPN_BATCH = 100000                  # every labelled anchor
ROI_BATCH = 4 * (POST_NMS + MAX_GT)  # every candidate, under the 25% cap
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3  # of each tensor's largest |gradient|

_CACHE = {}


def train_kwargs(depth=14, stride_in_1x1=True):
    return dict(tiny_kwargs(depth, stride_in_1x1),
                rpn_batch_per_image=RPN_BATCH, roi_batch_per_image=ROI_BATCH)


def gt_arrays(hw, seed=3):
    """Four GT boxes per image inside its valid region, padded to MAX_GT."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((2, MAX_GT, 4), np.float32)
    classes = np.zeros((2, MAX_GT), np.int32)
    valid = np.zeros((2, MAX_GT), bool)
    for i in range(2):
        ih, iw = hw[i]
        x1 = rng.uniform(0, iw - 40, 4)
        y1 = rng.uniform(0, ih - 40, 4)
        bw, bh = rng.uniform(16, 60, 4), rng.uniform(16, 60, 4)
        boxes[i, :4] = np.stack([x1, y1, np.minimum(x1 + bw, iw),
                                 np.minimum(y1 + bh, ih)], axis=1)
        classes[i, :4] = rng.randint(0, NUM_CLASSES, 4)
        valid[i, :4] = True
    return boxes, classes, valid


def port_gt(boxes, classes, valid):
    return GTInstances(torch.from_numpy(boxes), torch.from_numpy(classes),
                       torch.from_numpy(valid))


def jax_params(depth=14, stride_in_1x1=True):
    key = (depth, stride_in_1x1)
    if key not in _CACHE:
        canvas, hw, orig = inputs(False)
        jmodel = JaxRCNN(**train_kwargs(depth, stride_in_1x1),
                         cls_dropout=False)
        variables = jmodel.init({"params": jax.random.PRNGKey(0)},
                                jax_images(canvas, hw, orig), train=False)
        _CACHE[key] = (jmodel, _perturb(jax.device_get(variables["params"])))
    return _CACHE[key]


def port_model(params, **overrides):
    kw = dict(train_kwargs(), **overrides)
    model = GeneralizedRCNN(**kw)
    model.load_state_dict(state_dict_from_jax_params(params))
    return model.train()


def total_loss(losses):
    return sum(v for k, v in losses.items() if not k.startswith("metric/"))


def jax_grads_by_name(grads):
    """Flax gradient tree -> {port parameter name: numpy array}."""
    out = {}
    for path, g in traverse_util.flatten_dict(grads).items():
        name, kind = jax_path_to_d2(path)
        if name is not None:
            out[name] = _to_torch_layout(np.asarray(g), kind)
    return out


# test_train_losses_and_gradients_match_jax's cases; the last two are run
# by tests/test_torch_train_model_deep.py (each file a small share of one
# xdist worker)
TRAIN_CASES = [(14, True, False), (14, True, True), (14, False, True),
               (26, True, True)]


@pytest.mark.parametrize("depth,stride_in_1x1,padded", TRAIN_CASES[:2])
def test_train_losses_and_gradients_match_jax(depth, stride_in_1x1, padded):
    check_train_case(depth, stride_in_1x1, padded)


def check_train_case(depth, stride_in_1x1, padded):
    jmodel, params = jax_params(depth, stride_in_1x1)
    canvas, hw, orig = inputs(padded)
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

    model = port_model(params, depth=depth, stride_in_1x1=stride_in_1x1)
    losses = model.forward_train(port_images(canvas, hw, orig),
                                 port_gt(gb, gc, gv),
                                 torch.Generator().manual_seed(0))
    total_loss(losses).backward()

    assert set(losses) == set(jl)
    for k in jl:
        np.testing.assert_allclose(losses[k].item(), float(jl[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert losses["loss_box_reg"].item() > 0
    assert losses["metric/roi_num_fg_samples"].item() > 0

    ref = jax_grads_by_name(jg)
    named = dict(model.named_parameters())
    one_per_subsystem = (
        "affine_rpn.weight", "affine_rcnn.weight",
        "proposal_generator.rpn_head.conv.weight",
        "backbone.stem.conv1.weight", "backbone.res3.0.conv1.weight",
        "backbone.res4.0.conv2.weight", "roi_heads.res5.0.conv3.weight",
        "roi_heads.box_predictor.cls_score.weight",
        "roi_heads.box_predictor.bbox_pred.weight",
    )
    for name in one_per_subsystem:
        assert float(named[name].grad.abs().max()) > 0, name
    for name, param in named.items():
        want = ref[name]
        np.testing.assert_allclose(
            param.grad.numpy(), want, rtol=0,
            atol=GRAD_TOL * float(np.abs(want).max()), err_msg=name)


def test_cls_dropout_keeps_one_in_five_scaled_by_five_in_training_only():
    torch.manual_seed(0)
    layer = FastRCNNOutputLayers(64, NUM_CLASSES, cls_dropout=True,
                                 dropout_ratio=0.8)
    x = torch.rand(4096, 64) + 0.5
    # eval: identity
    s_eval, d_eval = layer(x)
    s_plain = torch.nn.functional.linear(x, layer.cls_score.weight,
                                         layer.cls_score.bias)
    torch.testing.assert_close(s_eval, s_plain, rtol=0, atol=0)
    # training: only the cls input is dropped, from the generator
    s1, d1 = layer(x, train=True, generator=torch.Generator().manual_seed(7))
    s2, _ = layer(x, train=True, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)
    torch.testing.assert_close(d1, d_eval, rtol=0, atol=0)
    assert not torch.equal(s1, s_eval)
    dropped = cls_dropout(x, 0.8, torch.Generator().manual_seed(7))
    kept = dropped != 0
    share = float(kept.float().mean())
    assert abs(share - 0.2) < 0.01, share  # 262144 draws: sd 0.0008
    torch.testing.assert_close(dropped[kept], x[kept] * 5.0, rtol=1e-6,
                               atol=0)
    torch.testing.assert_close(
        s1, torch.nn.functional.linear(dropped, layer.cls_score.weight,
                                       layer.cls_score.bias))
