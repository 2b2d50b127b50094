"""The port's text-family ROI heads against the JAX package's, on the CPU,
float32, inside the whole tiny detector of tests/test_torch_train_model.py
(depth 14, 128x160, exhaustive sampling budgets, dropout off): the two
Sematic heads and the four Text heads, every loss (rtol 1e-4) and the
gradient of every parameter (within 1e-3 of its largest value), the JAX
params carried over by ``state_dict_from_jax_params`` (strict: every text
parameter has its name). Then inference: the student alone, and the
teacher on GT-labelled proposals. Then the port's own contracts:
MODEL.ADDITION.FREEZEATTENTION, ``surgery_reset_student`` and the
``reset_student`` tool, and the reference's ``stu_box_predictor`` tensors
through the weight import.
"""

import copy
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    GeneralizedRCNN as JaxRCNN,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    text_heads as jtext,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    GTInstances as JaxGT,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    init_weights,
    load_reference_weights,
    state_dict_from_jax_params,
    surgery_randinit,
    surgery_reset_student,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    GeneralizedRCNN,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    text_heads as ttext,
)
from tests.test_full_network_oracle import _perturb
from tests.test_torch_text_attention import SEM, bank, bg
from tests.test_torch_model import (
    NUM_CLASSES,
    inputs,
    jax_images,
    match_detections,
    port_images,
    tiny_kwargs,
)
from tests.test_torch_train_model import (
    gt_arrays,
    jax_grads_by_name,
    port_gt,
    total_loss,
)

POST_NMS = 64
MAX_GT = 8
RPN_BATCH = 100000                  # every labelled anchor
ROI_BATCH = 4 * (POST_NMS + MAX_GT)  # every candidate, under the 25% cap
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3  # of each tensor's largest |gradient|
# One exception: the Sematic head's w_q and dummy-key gradients. Every row's
# attention sits above 0.9999 on the dummy key, and the softmax backward of
# that column is a difference of nearly equal float32 sums: from the same
# pooled features both packages' float32 miss the float64 value by about
# 4e-3 of the largest value, so 1e-3 between them is below float32's floor.
# They are held within 1e-2; test_sematic_cancelling_gradients_are_float32_
# noise is the witness.
CANCELLING = {("SematicRes5ROIHeads", n): 1e-2 for n in (
    "roi_heads.attention.attention.dummy",
    "roi_heads.attention.attention.w_q.weight")}

HEADS = ["SematicRes5ROIHeads", "SematicRes5ROIHeadsCrossOutput",
         "TextRes5ROIHeads", "TextRes5ROIHeads_VKV",
         "TextRes5ROIHeads_textDomination",
         "TextRes5ROIHeads_textDomination_VKV"]

_CACHE = {}


def text_kwargs(head="Res5ROIHeads", **extra):
    """The tiny detector's arguments, shared by both packages: exhaustive
    budgets, dropout off, the student recipe's distillation flags."""
    return dict(tiny_kwargs(), rpn_post_nms_topk=(POST_NMS, POST_NMS),
                rpn_batch_per_image=RPN_BATCH, roi_batch_per_image=ROI_BATCH,
                cls_dropout=False, roi_heads_name=head, class_embed=bank(),
                bg_embed=bg(), distill_l2=True, distill_kl=True, kl_temp=5.0,
                **extra)


def jax_batch(padded=True):
    canvas, hw, orig = inputs(padded)
    gb, gc, gv = gt_arrays(hw)
    return (jax_images(canvas, hw, orig),
            JaxGT(jnp.asarray(gb), jnp.asarray(gc), jnp.asarray(gv)),
            port_images(canvas, hw, orig), port_gt(gb, gc, gv))


def jax_model(meta="GeneralizedRCNN", **kw):
    """(jax model, perturbed params) of ``meta`` with ``text_kwargs(**kw)``,
    initialised in training (the teacher's parameters exist only there)."""
    key = (meta, tuple(sorted((k, str(v)) for k, v in kw.items())))
    if key not in _CACHE:
        args = text_kwargs(**kw)
        if meta == "GeneralizedRCNN":
            jmodel = JaxRCNN(**args)
        else:
            cls = {"GeneralizedDistillatedAddingRCNN":
                   jtext.GeneralizedDistillatedRCNN}.get(
                       meta, getattr(jtext, meta, None))
            extra = ({"adding_variant": True}
                     if meta == "GeneralizedDistillatedAddingRCNN" else {})
            jmodel = cls(semantic_dim=SEM, **extra, **args)
        images, gt, _, _ = jax_batch(False)
        variables = jax.jit(functools.partial(jmodel.init, train=True))(
            {"params": jax.random.PRNGKey(0),
             "sampling": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)}, images, gt)
        _CACHE[key] = (jmodel, _perturb(jax.device_get(variables["params"])))
    return _CACHE[key]


def port_model(meta, params, **kw):
    args = text_kwargs(**kw)
    if meta == "GeneralizedRCNN":
        model = GeneralizedRCNN(**args)
    else:
        cls, extra = ttext.META_ARCHS[meta]
        model = cls(**extra, **args)
    model.load_state_dict(state_dict_from_jax_params(params))  # strict
    return model.train()


def check_train(meta="GeneralizedRCNN", head="Res5ROIHeads", **kw):
    """Losses and every gradient of one training forward, both packages;
    returns (port losses, port model)."""
    jmodel, params = jax_model(meta, head=head, **kw)
    images, gt, timages, tgt = jax_batch(True)

    def loss_fn(p):
        losses = jmodel.apply(
            {"params": p}, images, gt, train=True,
            rngs={"sampling": jax.random.PRNGKey(1),
                  "dropout": jax.random.PRNGKey(2)})
        return total_loss(losses), losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    jl = jax.device_get(jl)
    model = port_model(meta, params, head=head, **kw)
    losses = model.forward_train(timages, tgt,
                                 torch.Generator().manual_seed(0))
    total_loss(losses).backward()
    assert set(losses) == set(jl)
    for k in jl:
        np.testing.assert_allclose(losses[k].item(), float(jl[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    ref = jax_grads_by_name(jg)
    named = dict(model.named_parameters())
    # the reference also has gradients for the FrozenBN statistics, which
    # are buffers here
    assert set(named) <= set(ref)
    for name, param in named.items():
        want = ref[name]
        got = (np.zeros_like(want) if param.grad is None
               else param.grad.numpy())
        tol = CANCELLING.get((head, name), GRAD_TOL)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=tol * float(np.abs(want).max()),
            err_msg=name)
    return losses, model


# test_text_heads_train_like_jax's cases, run by
# tests/test_torch_text_heads_train{,_b,_c}.py (each file a small share of
# one xdist worker)
TRAIN_CASES = [*((h, False) for h in HEADS), ("TextRes5ROIHeads", True)]


def check_train_case(head, cosine):
    kw = {"l2_cosine": True} if cosine else {}
    losses, model = check_train(head=head, **kw)
    if head == "SematicRes5ROIHeads":
        assert "loss_attentive" in losses
    if head.startswith("Text"):
        assert {"loss_cls_t", "loss_box_reg_t", "loss_kl",
                "loss_student_feat"} <= set(losses)
        for name in ("roi_heads.attention.attention.w_q.weight",
                     "roi_heads.stu_box_predictor.cls_score.weight",
                     "roi_heads.mlp_adapter.0.weight",
                     "roi_heads.res5.0.conv1.weight"):
            assert float(dict(model.named_parameters())[name].grad
                         .abs().max()) > 0, name
    if cosine:
        assert losses["loss_student_feat"].item() <= 2.0


class _JaxSematicOnPooled(jtext.SematicRes5ROIHeads):
    """The JAX package's Sematic head, handed its pooled features."""

    def pooled_features(self, features, boxes):
        return features


def test_sematic_cancelling_gradients_are_float32_noise():
    """The witness of CANCELLING. The tiny detector's Sematic head from the
    pooled features of one port training forward on, with the same labels
    and upstream weights: the port in float32 and in float64 (exact, for
    float32), and the JAX package in float32 (it cannot run this head in
    float64: its QK^T einsum asks for a float32 result). Every gradient of
    both float32 runs is within GRAD_TOL of exact but the CANCELLING ones,
    which both runs miss by more (the port 4.7e-3, the JAX package 4.0e-3
    when written; every other gradient 1e-6) and are held within
    CANCELLING's bound. Every valid row's attention sits above 0.9999 on
    the dummy key, so the softmax backward of that column subtracts two
    nearly equal float32 sums, and the gradients of the dummy key and of
    w_q (which every row's dummy logit feeds) collect the rounding."""
    head = "SematicRes5ROIHeads"
    _, params = jax_model(head=head)
    _, _, timages, tgt = jax_batch(True)
    model = port_model("GeneralizedRCNN", params, head=head)
    seen = {}

    def grab(module, args, kwargs):
        seen["feat"] = module.pooled_features(*args[:2]).detach()
        seen["gt_classes"], seen["valid"] = (kwargs["gt_classes"],
                                             kwargs["valid"])

    model.roi_heads.register_forward_pre_hook(grab, with_kwargs=True)
    model.forward_train(timages, tgt, torch.Generator().manual_seed(0))
    feat = seen["feat"].numpy()
    gtc, valid = seen["gt_classes"].numpy(), seen["valid"].numpy()
    rng = np.random.default_rng(0)
    r = feat.shape[0]
    w_scores = rng.standard_normal((r, NUM_CLASSES + 1)) / r
    w_deltas = rng.standard_normal((r, 4 * NUM_CLASSES)) / r

    def port_grads(dtype):
        h = copy.deepcopy(model.roi_heads).to(dtype)
        h.pooled_features = lambda features, boxes: features
        scores, deltas, aux = h(
            torch.tensor(feat, dtype=dtype), None, train=True,
            gt_classes=torch.tensor(gtc), valid=torch.tensor(valid))
        (aux["loss_attentive"]
         + (scores * torch.tensor(w_scores, dtype=dtype)).sum()
         + (deltas * torch.tensor(w_deltas, dtype=dtype)).sum()).backward()
        return {f"roi_heads.{n}": p.grad.double().numpy()
                for n, p in h.named_parameters() if p.grad is not None}

    jhead = _JaxSematicOnPooled(
        num_classes=NUM_CLASSES, res2_out_channels=16, width_per_group=4,
        class_embed=bank(), bg_embed=bg())

    def jax_loss(p):
        scores, deltas, aux = jhead.apply(
            {"params": p}, jnp.asarray(feat), None, train=True,
            gt_classes=jnp.asarray(gtc), valid=jnp.asarray(valid))
        return (aux["loss_attentive"] + jnp.sum(scores * w_scores)
                + jnp.sum(deltas * w_deltas))

    jg = jax.grad(jax_loss)(params["roi_heads"])
    exact, port32 = port_grads(torch.float64), port_grads(torch.float32)
    jax32 = jax_grads_by_name({"roi_heads": jg})
    assert len(exact) > 10
    for name, want in exact.items():
        tol = CANCELLING.get((head, name), GRAD_TOL)
        scale = float(np.abs(want).max())
        for label, got in (("port", port32[name]), ("jax", jax32[name])):
            err = float(np.abs(got - want).max()) / scale
            assert err <= tol, (name, label, err)
            if (head, name) in CANCELLING:
                assert err > GRAD_TOL, (name, label, err)


def _detections(det, i):
    v = np.asarray(det.valid[i])
    return (np.asarray(det.boxes[i])[v], np.asarray(det.scores[i])[v],
            np.asarray(det.classes[i])[v])


@pytest.mark.parametrize("head,with_gt", [
    ("TextRes5ROIHeads", False), ("TextRes5ROIHeads", True),
    ("TextRes5ROIHeads_textDomination_VKV", True),
    ("SematicRes5ROIHeadsCrossOutput", False)])
def test_text_heads_inference_like_jax(head, with_gt):
    """Without GT the Text heads run the student; with GT (the teacher
    role) the proposals are labelled by their matched GT class and the
    teacher runs."""
    jmodel, params = jax_model(head=head)
    images, gt, timages, tgt = jax_batch(True)
    det = jax.device_get(jax.jit(functools.partial(
        jmodel.apply, train=False))({"params": params}, images,
                                    gt if with_gt else None))
    port = port_model("GeneralizedRCNN", params, head=head).eval()
    with torch.no_grad():
        tdet = port.forward_inference(timages, tgt if with_gt else None)
        other = port.forward_inference(timages, None if with_gt else tgt)
    assert int(np.asarray(det.valid).sum()) > 10
    for i in range(2):
        match_detections(_detections(tdet, i), _detections(det, i))
    if head.startswith("Text"):  # the teacher and the student differ
        assert not torch.equal(tdet.scores, other.scores)


def _text_state():
    model = GeneralizedRCNN(**text_kwargs("TextRes5ROIHeads"))
    init_weights(model, torch.Generator().manual_seed(0))
    return model, model.state_dict()


def test_reset_student_redraws_the_student_alone():
    _, state = _text_state()
    new, n = surgery_reset_student(state, seed=123)
    student = [k for k in state if ".stu_box_predictor." in k
               or ".mlp_adapter." in k]
    assert n == len(student) == 8
    again, _ = surgery_reset_student(state, seed=123)
    for k, v in state.items():
        if k in student:
            assert torch.equal(new[k], again[k]), k
            if k.endswith(".bias"):
                assert not new[k].any(), k
            else:  # N(0, 1 / fan_in)
                std = float(new[k].double().std()) * np.sqrt(v.shape[1])
                assert 0.9 < std < 1.1, (k, std)
                assert not torch.equal(new[k], v), k
        else:
            assert torch.equal(new[k], v), k
    flagship = {k: v for k, v in state.items() if k not in student}
    with pytest.raises(ValueError, match="student branch not found"):
        surgery_reset_student(flagship)


def test_reset_student_tool_and_the_base_width_student(tmp_path):
    """randinit widens box_predictor only (as in the JAX package), so a
    student fine-tune meets a stu_box_predictor of base width: the weight
    import skips it by its shape and it keeps its seeded values."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        model_surgery,
    )

    model, state = _text_state()
    src = tmp_path / "model_final.pth"
    torch.save({"model": state, "iteration": 9}, src)
    out = model_surgery.main(["--dataset", "voc", "--method",
                              "reset_student", "--src-path", str(src),
                              "--save-dir", str(tmp_path), "--seed", "123"])
    assert out.endswith("model_reset_student.pth")
    saved = torch.load(out, weights_only=True)
    assert saved["iteration"] == 0
    want, _ = surgery_reset_student(state, seed=123)
    for k in want:
        assert torch.equal(saved["model"][k], want[k]), k
    wide = surgery_randinit(saved["model"], NUM_CLASSES + 3)
    assert wide["roi_heads.box_predictor.cls_score.weight"].shape[0] == (
        NUM_CLASSES + 4)
    assert wide["roi_heads.stu_box_predictor.cls_score.weight"].shape[0] == (
        NUM_CLASSES + 1)
    path = tmp_path / "wide.pth"
    torch.save({"model": wide}, path)
    novel = GeneralizedRCNN(**dict(text_kwargs("TextRes5ROIHeads"),
                                   num_classes=NUM_CLASSES + 3))
    init_weights(novel, torch.Generator().manual_seed(5))
    seeded = {k: v.clone() for k, v in novel.state_dict().items()}
    matched, skipped = load_reference_weights(str(path), novel)
    assert set(skipped) == {
        "roi_heads.stu_box_predictor.cls_score.weight",
        "roi_heads.stu_box_predictor.cls_score.bias",
        "roi_heads.stu_box_predictor.bbox_pred.weight",
        "roi_heads.stu_box_predictor.bbox_pred.bias"}
    got = novel.state_dict()
    for k in skipped:
        assert torch.equal(got[k], seeded[k]), k
    assert torch.equal(got["roi_heads.mlp_adapter.0.weight"],
                       wide["roi_heads.mlp_adapter.0.weight"])
    assert matched == len(wide) - 4


def test_reference_stu_box_predictor_tensors_load(tmp_path):
    """A detectron2 file of a text model: its stu_box_predictor tensors,
    which the flagship skips, load into a text model's."""
    model, state = _text_state()
    rng = np.random.RandomState(3)
    ref = {k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in state.items() if ".stu_box_predictor." in k}
    assert len(ref) == 4
    path = tmp_path / "ref.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in ref.items()}},
               path)
    matched, skipped = load_reference_weights(str(path), model)
    assert (matched, skipped) == (4, [])
    for k, v in ref.items():
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v)
    flagship = GeneralizedRCNN(**tiny_kwargs())
    _, skipped = load_reference_weights(str(path), flagship)
    assert sorted(skipped) == sorted(ref)


def test_init_weights_draws_the_text_parameters_as_jax_does():
    """A fresh text model's parameters from ``init_weights``: N(0, 0.02)
    for the siamese attention of the ROI head (FFN included), N(0,
    sqrt(2 / 2d)) Q/K/V and U(+-1/sqrt(fan_in)) linears for the TextAtt
    pixel attention, U(+-1/sqrt(fan_in)) projections, flax's lecun normal
    for the other linears, N(0, 1) tokens, the predictors' N(0, 0.01) and
    N(0, 0.001), zero biases and unit LayerNorm scales."""
    model = ttext.GeneralizedTextAttRCNN(**text_kwargs(
        "TextRes5ROIHeads"))
    init_weights(model, torch.Generator().manual_seed(0))
    p = {k: v.detach().double() for k, v in model.named_parameters()}

    def std_near(name, want, rel=0.1):
        got = float(p[name].std())
        assert abs(got / want - 1) < rel, (name, got, want)

    def uniform(name):
        bound = 1 / np.sqrt(p[name].shape[1])
        assert float(p[name].abs().max()) <= bound, name
        std_near(name, bound / np.sqrt(3))

    for name in ("roi_heads.attention.attention.w_q.weight",
                 "roi_heads.attention.attention.linear3.weight",
                 "roi_heads.attention.attention.ffn.linear1.weight"):
        std_near(name, 0.02)
    std_near("pixel_attention.w_k.weight", np.sqrt(2 / (2 * 64)))
    for name in ("pixel_attention.linear1.weight",
                 "pixel_attention.ffn.linear2.weight",
                 "roi_heads.attention.proj_k.weight",
                 "roi_heads.attention.proj2.weight"):
        uniform(name)
    for name in ("LtoVproj.weight", "attproj.weight",
                 "roi_heads.mlp_adapter.0.weight",
                 "roi_heads.mlp_adapter.2.weight"):
        fan_in = p[name].shape[1]
        std_near(name, 1 / np.sqrt(fan_in))
        assert float(p[name].abs().max()) <= 2 / np.sqrt(fan_in) / 0.8796
    for name in ("pixel_attention.dummy", "roi_heads.attention.w_bg",
                 "roi_heads.attention.attention.dummy"):
        std_near(name, 1.0, rel=0.3)
    std_near("roi_heads.stu_box_predictor.cls_score.weight", 0.01)
    std_near("roi_heads.stu_box_predictor.bbox_pred.weight", 0.001)
    for name, v in p.items():
        if name.endswith(".bias"):
            assert not v.any(), name
        if name.endswith("norm3.weight"):
            assert bool((v == 1).all()), name
    assert p["bg_feature"].shape == (1, SEM) and p["bg_feature"].any()
