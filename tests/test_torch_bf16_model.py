"""The port's default compute dtype, bfloat16, held to the JAX package's on
the CPU: the detector's serving path.

R is the JAX package in float32, J the JAX package in bfloat16, T the port
in bfloat16, all three on the same inputs and the same params, under the
rule of ``tools/bf16_parity.py`` with T as its X, fixed before any of
these tests ran:
  1. a tensor (features, pooled features, head outputs, losses,
     gradients, updates): e(T) <= 2 e(J) + u;
  2. proposals and detections computed from the same bf16-rounded head
     outputs: the same sets as the JAX package's, exactly;
  3. end to end: of the valid detections, the number that T matches in J
     (IoU > 0.9, same class) is at least the number that J matches in R.
A failure is a fault of the port to repair, never a tolerance to widen.

The cases are those of ``tools/bf16_parity.py``, which chip_smoke.py
phase 19 runs on the card too: the tiny detector of
tests/test_torch_model.py (depth 14, 128x160 canvas, two images, one
padded) on the port's seeded ``init_weights``, perturbed so that every
tensor matters and carried into the JAX tree (``jax_params_like``); the
JAX side is never initialised, only shaped. Here: res4 and the pooled
features with ``stride_in_1x1`` both ways, RPN proposal selection and Fast
R-CNN inference on the same bf16 head outputs, ``forward_inference``
padded and unpadded (StandardROIHeads too), ``predict_batch``, and one
batch under TPU.DEVICE_PREPROCESS; and that the shared cases are the
parity suites' own fixtures. tests/test_torch_bf16_train.py and
tests/test_torch_bf16_text.py hold training and the text families to the
same rule.
"""

import functools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from fewshotobjectdetection_imporove_via_text_feature_tpu.data.xla_preprocess import (
    device_resize_batch as jax_resize,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    GeneralizedRCNN as JaxRCNN,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.models.fast_rcnn import (
    fast_rcnn_inference as jax_fast_rcnn_inference,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.models.rpn import (
    select_top_proposals as jax_select,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    ImageBatch as JaxImageBatch,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    state_dict_from_jax_params,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint.convert import (
    _first_fc_channels,
    jax_path_to_d2,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data.device_preprocess import (
    preprocess_batch,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    DefaultPredictor,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    GeneralizedRCNN,
    cell_anchors,
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
    H,
    W,
    image_batch,
    seed_weights,
    tiny_inputs,
    tiny_kwargs,
)

_CACHE = {}


# ------------------------------------------------------------- the rule
def rule1(name, t, j, r):
    """Rule 1 on one tensor; returns (e(T), e(J))."""
    r = as_numpy(r)
    assert np.abs(r).max() > 0, name  # has teeth
    et, ej, limit = cases.rule1(as_numpy(t), as_numpy(j), r)
    print(f"rule 1 {name}: e(T) {et:.4e}, e(J) {ej:.4e}")
    assert et <= limit, f"{name}: e(T) {et:.4e} > 2 e(J) + u = {limit:.4e}"
    return et, ej


def as_numpy(x):
    """A tensor of either package, or an array, as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def valid_detections(det):
    """Detections (either package) -> [(boxes, classes)] of each image's
    valid rows."""
    out = []
    for i in range(np.asarray(det.valid).shape[0]):
        v = np.asarray(det.valid[i])
        out.append((as_numpy(det.boxes[i])[v], np.asarray(det.classes[i])[v]))
    return out


def rule3(t, j, r):
    """Rule 3 on [(boxes, classes)] per image; returns (T in J, J in R)."""
    tj, jr, counts = cases.rule3(t, j, r)
    assert min(counts.values()) > 10, counts  # has teeth
    print(f"rule 3: T matches {tj} in J, J {jr} in R, of {counts} valid")
    assert tj >= jr, f"T matches {tj} in J, J matches {jr} in R"
    return tj, jr


def jax_images(canvas, hw, orig):
    return JaxImageBatch(image=jnp.asarray(canvas), hw=jnp.asarray(hw),
                         orig_hw=jnp.asarray(orig))


# ------------------------------------------------------------- weights
def jax_params_like(shapes, port):
    """The port model's state (seeded and perturbed by
    ``seed_weights``), carried into the JAX param tree of ``shapes`` (a
    ``jax.eval_shape`` of the JAX init) by the inverse of
    ``state_dict_from_jax_params``."""
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    inverse = {"conv": lambda v: v.transpose(2, 3, 1, 0),
               "linear": lambda v: v.T, "affine": lambda v: v.reshape(-1)}
    flat = {}
    for path, leaf in traverse_util.flatten_dict(shapes).items():
        name, kind = jax_path_to_d2(path)
        if kind == "fc_first":  # torch (out, C*P*P) -> flax (P*P*C, out)
            c = _first_fc_channels(shapes, path[1])
            w = state[name]
            p = math.isqrt(w.shape[1] // c)
            value = w.reshape(-1, c, p, p).transpose(2, 3, 1, 0).reshape(
                leaf.shape)
        else:
            value = inverse.get(kind, lambda v: v)(state[name])
        assert value.shape == leaf.shape, (path, value.shape, leaf.shape)
        flat[path] = value
    params = traverse_util.unflatten_dict(flat)
    back = state_dict_from_jax_params(params)
    assert all(np.array_equal(back[k].numpy(), state[k]) for k in state)
    port.load_state_dict(back)  # strict
    return params


def shaped(jmodel, *args, **kw):
    """The JAX init's param shapes, traced, not compiled."""
    return jax.eval_shape(functools.partial(jmodel.init, **kw),
                          {"params": jax.random.PRNGKey(0),
                           "sampling": jax.random.PRNGKey(1),
                           "dropout": jax.random.PRNGKey(2)},
                          *args)["params"]


def flagship(**overrides):
    """(R, J, params, T): the JAX model in float32 and bfloat16, the shared
    params, and the port in bfloat16 on them (eval mode)."""
    key = tuple(sorted(overrides.items()))
    if key not in _CACHE:
        kw = dict(tiny_kwargs(), **overrides)
        jmodel = JaxRCNN(**kw)
        port = GeneralizedRCNN(**kw, dtype=torch.bfloat16)
        seed_weights(port)
        shapes = shaped(jmodel, jax_images(*tiny_inputs(False)),
                        train=False)
        params = jax_params_like(shapes, port)
        _CACHE[key] = (jmodel, jmodel.clone(dtype=jnp.bfloat16), params,
                       port.eval())
    return _CACHE[key]


# ------------------------------------------------------------- the tests
@pytest.mark.parametrize("stride_in_1x1", [True, False])
def test_bf16_res4_and_pooled_features_hold_to_jax(stride_in_1x1):
    rmodel, jmodel, params, port = flagship(stride_in_1x1=stride_in_1x1)
    images = tiny_inputs(True)

    def res4(m, im):
        return m.compute_features(im)[0]

    r = jax.jit(lambda p: rmodel.apply({"params": p}, jax_images(*images),
                                       method=res4))(params)
    jf = jax.jit(lambda p: jmodel.apply({"params": p}, jax_images(*images),
                                        method=res4))(params)
    assert jf.dtype == jnp.bfloat16
    with torch.no_grad():
        t, _ = port.compute_features(image_batch(*images))
    assert t.dtype == torch.bfloat16
    rule1("res4", t.permute(0, 2, 3, 1), jf, r)

    # pooled res5 features, all three fed J's bf16 res4 (R its float32
    # values): ROIAlign, res5 and the float32 spatial mean
    boxes = cases.pooled_boxes()

    def pool(m, f, b):
        return m.roi_heads.pooled_features(f, b)

    r = rmodel.apply({"params": params}, jf.astype(jnp.float32),
                     jnp.asarray(boxes), method=pool)
    j = jmodel.apply({"params": params}, jf, jnp.asarray(boxes), method=pool)
    with torch.no_grad():
        t = port.roi_heads.pooled_features(
            torch.from_numpy(as_numpy(jf).copy()).to(torch.bfloat16)
            .permute(0, 3, 1, 2), torch.from_numpy(boxes))
    assert t.dtype == torch.float32
    rule1("pooled features", t, j, r)


def test_bf16_rpn_head_and_proposals_hold_to_jax():
    """The RPN head's float32 logits and deltas under rule 1; then
    proposal selection on J's own bf16-rounded head outputs, full of
    ties: the same proposals as the JAX package's, at the training and the
    test top-k."""
    rmodel, jmodel, params, port = flagship()
    canvas, hw, orig = tiny_inputs(True)

    def head(m, im):
        feat, _ = m.compute_features(im)
        return m.rpn_head(m.branch_features(feat)[0])

    out = {n: jax.jit(lambda p, m=m: m.apply(
        {"params": p}, jax_images(canvas, hw, orig), method=head))(params)
        for n, m in (("R", rmodel), ("J", jmodel))}
    with torch.no_grad():
        feat, _ = port.compute_features(image_batch(canvas, hw, orig))
        tl, td = port.proposal_generator.rpn_head(
            port.branch_features(feat)[0])
    assert tl.dtype == td.dtype == torch.float32
    rule1("rpn logits", tl, out["J"][0], out["R"][0])
    rule1("rpn deltas", td, out["J"][1], out["R"][1])

    logits, deltas = (as_numpy(x) for x in out["J"])
    assert len(np.unique(logits)) < logits.size  # bf16 ties
    fh, fw = H // 16, W // 16
    cell = cell_anchors()
    for pre, post in ((1200, 300), (600, 1000)):
        jp = jax_select(jnp.asarray(logits), jnp.asarray(deltas),
                        jnp.asarray(cell), (fh, fw), 16, jnp.asarray(hw),
                        pre_nms_topk=pre, post_nms_topk=post)
        tp = select_top_proposals(torch.from_numpy(logits),
                                  torch.from_numpy(deltas), cell, (fh, fw),
                                  16, torch.from_numpy(hw), pre, post)
        np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
        np.testing.assert_array_equal(tp.objectness.numpy(),
                                      np.asarray(jp.objectness))
        np.testing.assert_allclose(tp.boxes.numpy(), np.asarray(jp.boxes),
                                   rtol=0, atol=1e-4)


def test_bf16_fast_rcnn_inference_on_the_same_head_outputs_equals_jax():
    """Final detections from box-head outputs rounded to bf16 (ties in the
    scores, as a bf16 head gives them): the same sets as the JAX
    package's."""
    (logits, deltas, boxes, valid, hw), kw = cases.head_outputs()
    b = len(logits)
    out = fast_rcnn_inference(torch.from_numpy(logits),
                              torch.from_numpy(deltas),
                              torch.from_numpy(boxes),
                              torch.from_numpy(valid), torch.from_numpy(hw),
                              **kw)
    for i in range(b):
        ref = jax_fast_rcnn_inference(
            jnp.asarray(logits[i]), jnp.asarray(deltas[i]),
            jnp.asarray(boxes[i]), jnp.asarray(valid[i]), jnp.asarray(hw[i]),
            **kw)
        assert int(np.asarray(ref[3]).sum()) > 10
        np.testing.assert_array_equal(out[3][i].numpy(), np.asarray(ref[3]))
        np.testing.assert_array_equal(out[2][i].numpy(), np.asarray(ref[2]))
        np.testing.assert_allclose(out[1][i].numpy(), np.asarray(ref[1]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out[0][i].numpy(), np.asarray(ref[0]),
                                   rtol=1e-6, atol=1e-4)


def _infer(rmodel, jmodel, params, port, images, port_batch):
    """Rule 3 on one batch: R and J through ``jax.jit(apply)``, T through
    ``forward_inference`` on ``port_batch``."""
    r, j = (jax.device_get(jax.jit(functools.partial(m.apply, train=False))(
        {"params": params}, images)) for m in (rmodel, jmodel))
    with torch.no_grad():
        t = port.forward_inference(port_batch)
    return rule3(valid_detections(t), valid_detections(j),
                 valid_detections(r))


def test_bf16_device_preprocess_holds_to_jax():
    """TPU.DEVICE_PREPROCESS: raw batches resized and flipped on the device
    (float32 in both packages), then the bf16 detector."""
    rmodel, jmodel, params, port = flagship()
    raw, hw, orig, short, flip = cases.raw_batch()
    jr, _ = jax_resize(jnp.asarray(raw), jnp.asarray(orig), jnp.asarray(flip),
                       jnp.asarray(short), W, (H, W))
    tb = preprocess_batch(
        ImageBatch(torch.from_numpy(raw), torch.from_numpy(hw),
                   torch.from_numpy(orig)),
        {"short": short, "flip": flip, "target_hw": (H, W), "max_size": W})
    assert tb.image.dtype == torch.float32
    # the resize is float32 on both sides: R and J are the same tensor
    rule1("resized batch", tb.image, jr, jr)
    _infer(rmodel, jmodel, params, port,
           JaxImageBatch(image=jr, hw=jnp.asarray(hw),
                         orig_hw=jnp.asarray(orig)), tb)


def _equal(a, b):
    """Two fixtures (arrays, dicts and sequences of them) hold the same
    values."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def test_bf16_cases_are_the_parity_suites_fixtures():
    """The shared cases of ``tools/bf16_parity.py`` (run on the card by
    chip_smoke.py phase 19) are the float32 parity suites' own fixtures:
    inputs, GT, model arguments, configs and images."""
    from test_torch_solver import BASE, _step_cfg
    from tests.test_torch_device_preprocess import _raw_batch
    from tests.test_torch_export_serving import _image, tiny_cfg
    from tests.test_torch_model import inputs
    from tests.test_torch_model import tiny_kwargs as model_kwargs
    from tests.test_torch_predictor import _images, _tiny
    from tests.test_torch_text_heads import text_kwargs
    from tests.test_torch_text_meta_archs import DISTILL_HEAD
    from tests.test_torch_train_model import gt_arrays, train_kwargs

    for padded in (False, True):
        assert _equal(tiny_inputs(padded), inputs(padded))
        hw = inputs(padded)[1]
        assert _equal(cases.tiny_gt(hw), gt_arrays(hw))
    for stride in (True, False):
        assert tiny_kwargs(stride) == model_kwargs(stride_in_1x1=stride)
    assert dict(tiny_kwargs(), **cases.train_kwargs()) == dict(
        train_kwargs(), cls_dropout=False)
    assert _equal(cases.text_kwargs("GeneralizedTextRCNN"), text_kwargs())
    assert _equal(cases.text_kwargs("GeneralizedDistillatedRCNN"),
                  text_kwargs(**DISTILL_HEAD))
    for dt in ("float32", "bfloat16"):
        ref = _tiny(get_cfg())
        ref.TPU.COMPUTE_DTYPE = dt
        assert cases.predictor_cfg(dt) == ref
        assert cases.export_cfg(dt) == tiny_cfg(["TPU.COMPUTE_DTYPE", dt])
    assert cases.step_cfg(BASE) == _step_cfg()
    assert _equal(cases.raw_batch(), _raw_batch()[:5])
    assert _equal(cases.predictor_images(), _images() + _images()[:1])
    assert _equal(cases.export_images(),
                  [_image(hw, sum(hw)) for hw in ((100, 150), (150, 100))])
