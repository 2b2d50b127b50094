"""The port's bfloat16 training held to the JAX package's on the CPU, by
the rule of tests/test_torch_bf16_model.py (R the JAX package in float32,
J in bfloat16, T the port in bfloat16; rule 1: e(T) <= 2 e(J) + u per
tensor).

The tiny detector of tests/test_torch_train_model.py (depth 14, 128x160,
the padded batch, exhaustive sampling budgets so that the draws of the
two packages choose the same sets, dropout off), with GDL at lambda_rpn 0
and lambda_rcnn 0.75, on the port's seeded and perturbed weights carried
into the JAX tree: the cases of ``tools/bf16_parity.py``, which
chip_smoke.py phase 19 runs on the card too. Compared: every loss and every parameter's gradient
of one training forward, and each parameter's update after three SGD
steps of ``make_train_step`` against the JAX package's (the base
contract of tests/test_torch_solver_steps.py: FREEZE_AT 2, momentum,
weight decay, warm-up, norm clipping).
"""

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
    state_dict_from_jax_params,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    make_train_step,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    GeneralizedRCNN,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.solver import (
    build_optimizer,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    bf16_parity as cases,
)
from tests.test_torch_bf16_model import (
    jax_images,
    jax_params_like,
    rule1,
    shaped,
)
from tests.test_torch_train_model import jax_grads_by_name, total_loss

_CACHE = {}


def models():
    """(JAX model in float32, the params, a function making the port's
    bf16 training model on them)."""
    if "m" not in _CACHE:
        kw = dict(cases.tiny_kwargs(), **cases.train_kwargs())
        jmodel = JaxRCNN(**kw)

        def port():
            return GeneralizedRCNN(**kw, dtype=torch.bfloat16).train()

        model = port()
        cases.seed_weights(model)
        params = jax_params_like(
            shaped(jmodel, jax_images(*cases.tiny_inputs(False)),
                   train=False), model)
        _CACHE["m"] = (jmodel, params, port)
    return _CACHE["m"]


def batch():
    canvas, hw, orig = cases.tiny_inputs(True)
    gb, gc, gv = cases.tiny_gt(hw)
    return ((jax_images(canvas, hw, orig),
             JaxGT(jnp.asarray(gb), jnp.asarray(gc), jnp.asarray(gv))),
            (cases.image_batch(canvas, hw, orig),
             cases.gt_instances(gb, gc, gv)))


def test_bf16_train_losses_and_gradients_hold_to_jax():
    jmodel, params, make = models()
    (jimages, jgt), (images, gt) = batch()
    ref = {}
    for name, dt in (("R", jnp.float32), ("J", jnp.bfloat16)):
        m = jmodel.clone(dtype=dt)

        def loss_fn(p, m=m):
            losses = m.apply({"params": p}, jimages, jgt, train=True,
                             rngs={"sampling": jax.random.PRNGKey(1),
                                   "dropout": jax.random.PRNGKey(2)})
            return total_loss(losses), losses

        (_, losses), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        ref[name] = (jax.device_get(losses), jax_grads_by_name(grads))

    model = make()
    model.load_state_dict(state_dict_from_jax_params(params))
    assert model.rpn_backward_scale == 0.0
    assert model.roi_backward_scale == 0.75
    losses = model.forward_train(images, gt, torch.Generator().manual_seed(0))
    total_loss(losses).backward()
    (rl, rg), (jl, jg) = ref["R"], ref["J"]
    assert set(losses) == set(rl)
    for k in rl:
        if not k.startswith("metric/"):
            rule1(k, losses[k], jl[k], rl[k])
    # the sampled sets: every labelled anchor and every candidate ROI
    for k in ("metric/rpn_num_pos_anchors", "metric/roi_num_fg_samples"):
        assert losses[k].item() == float(jl[k]) > 0, k
    named = dict(model.named_parameters())
    assert set(named) <= set(rg)
    for name, param in named.items():
        assert param.grad.dtype == torch.float32, name
        assert float(param.grad.abs().max()) > 0, name
        rule1(name, param.grad, jg[name], rg[name])


