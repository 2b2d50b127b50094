"""The text families in bfloat16 held to the JAX package's on the CPU, by
the rule of tests/test_torch_bf16_model.py (R the JAX package in float32,
J in bfloat16, T the port in bfloat16; rule 1 per tensor, rule 3 on the
detections), and one bf16 serving export against eager bf16.

The meta-archs of tests/test_torch_text_meta_archs.py at its tiny size
(depth 14, 128x160, exhaustive sampling budgets, dropout off, the student
recipe's distillation flags): GeneralizedTextRCNN and
GeneralizedTextAttRCNN, their text map fused into res4 in float32 and
cast back to the compute dtype, on the port's seeded and perturbed
weights carried into the JAX tree: the cases of ``tools/bf16_parity.py``,
which chip_smoke.py phase 19 runs on the card too
(tests/test_torch_bf16_semantic.py holds
the Semantic and Distillated families with these functions). Compared:
every loss and every parameter's gradient of one training forward, and
the detections of ``forward_inference`` with test-time GT (painted by
the painting archs, ignored by Distillated).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    text_heads as jtext,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    GTInstances as JaxGT,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    text_heads as ttext,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    bf16_parity as cases,
)
from tests.test_torch_bf16_model import (
    jax_images,
    jax_params_like,
    rule1,
    rule3,
    shaped,
    valid_detections,
)
from tests.test_torch_train_model import jax_grads_by_name, total_loss

# the Semantic and Distillated families: tests/test_torch_bf16_semantic.py
ARCHS = ["GeneralizedTextRCNN", "GeneralizedTextAttRCNN"]

_CACHE = {}


def jax_batch(padded=True):
    """The tiny batch and its GT for both packages."""
    canvas, hw, orig = cases.tiny_inputs(padded)
    gb, gc, gv = cases.tiny_gt(hw)
    return (jax_images(canvas, hw, orig),
            JaxGT(jnp.asarray(gb), jnp.asarray(gc), jnp.asarray(gv)),
            cases.image_batch(canvas, hw, orig),
            cases.gt_instances(gb, gc, gv))


def run(meta):
    """R's and J's (losses, gradients by port name, detections), and the
    port's bf16 model on the same params, once per meta-arch."""
    if meta not in _CACHE:
        args = cases.text_kwargs(meta)
        jmodel = getattr(jtext, meta)(semantic_dim=cases.SEM, **args)
        cls, extra = ttext.META_ARCHS[meta]
        port = cls(**extra, **args, dtype=torch.bfloat16)
        cases.seed_weights(port)
        images, gt, _, _ = jax_batch(False)
        params = jax_params_like(shaped(jmodel, images, gt, train=True),
                                 port)
        images, gt, _, _ = jax_batch(True)
        ref = {}
        for name, dt in (("R", jnp.float32), ("J", jnp.bfloat16)):
            m = jmodel.clone(dtype=dt)

            def loss_fn(p, m=m):
                losses = m.apply({"params": p}, images, gt, train=True,
                                 rngs={"sampling": jax.random.PRNGKey(1),
                                       "dropout": jax.random.PRNGKey(2)})
                return total_loss(losses), losses

            (_, losses), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(params)
            det = jax.jit(functools.partial(m.apply, train=False))(
                {"params": params}, images, gt)
            ref[name] = (jax.device_get(losses), jax_grads_by_name(grads),
                         valid_detections(jax.device_get(det)))
        _CACHE[meta] = (ref, port)
    return _CACHE[meta]


def check_trains(meta):
    """Every loss and every parameter's gradient of one training forward
    under rule 1."""
    ref, port = run(meta)
    (rl, rg, _), (jl, jg, _) = ref["R"], ref["J"]
    _, _, timages, tgt = jax_batch(True)
    port.train()
    port.zero_grad(set_to_none=True)
    losses = port.forward_train(timages, tgt,
                                torch.Generator().manual_seed(0))
    total_loss(losses).backward()
    assert set(losses) == set(rl)
    for k in rl:
        if not k.startswith("metric/"):
            rule1(k, losses[k], jl[k], rl[k])
    assert losses["metric/roi_num_fg_samples"].item() == float(
        jl["metric/roi_num_fg_samples"]) > 0
    named = dict(port.named_parameters())
    assert set(named) <= set(rg)
    moved = 0
    for name, param in named.items():
        got = (np.zeros(rg[name].shape, np.float32) if param.grad is None
               else param.grad.float().numpy())
        if not np.abs(rg[name]).any():  # a parameter this loss never uses
            assert not got.any() and not np.abs(jg[name]).any(), name
            continue
        rule1(name, got, jg[name], rg[name])
        moved += 1
    assert moved > 10


def check_inference(meta):
    """``forward_inference`` with test-time GT (painted into the features
    by the Text, TextAtt and Semantic families, ignored by Distillated)
    under rule 3."""
    ref, port = run(meta)
    _, _, timages, tgt = jax_batch(True)
    port.eval()
    with torch.no_grad():
        det = port.forward_inference(timages, tgt)
    rule3(valid_detections(det), ref["J"][2], ref["R"][2])


@pytest.mark.parametrize("meta", ARCHS)
def test_bf16_text_meta_arch_trains_like_jax(meta):
    check_trains(meta)


@pytest.mark.parametrize("meta", ARCHS)
def test_bf16_text_meta_arch_inference_holds_to_jax(meta):
    check_inference(meta)


