"""Each parameter's update after 3 bf16 SGD steps of the port held to the
JAX package's make_train_step by the bf16 rule (base contract); split
from tests/test_torch_bf16_train.py so that each file is a small share
of one xdist worker."""

import numpy as np

import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from fewshotobjectdetection_imporove_via_text_feature_tpu.engine.trainer import (
    make_train_step as jax_make_train_step,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.solver.build import (
    build_optimizer as jax_build_optimizer,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    state_dict_from_jax_params,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint.convert import (
    _to_torch_layout,
    jax_path_to_d2,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    make_train_step,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    GeneralizedRCNN,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.solver import (
    build_gradient_clipper,
    build_optimizer,
    build_scheduler,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    bf16_parity as cases,
)
from test_torch_solver import BASE
from tests.test_torch_bf16_model import rule1
from tests.test_torch_train_model import total_loss
from tests.test_torch_bf16_train import (  # noqa: F401
    batch,
    models,
)


def test_bf16_three_sgd_steps_hold_to_jax_make_train_step():
    """Each parameter's update (final minus initial) after three SGD steps
    under rule 1; the frozen stem and res2 unmoved on all three."""
    jmodel, params, make = models()
    (jimages, jgt), (images, gt) = batch()
    cfg = cases.step_cfg(BASE)  # FREEZE_AT 2, decay 1e-3
    initial = traverse_util.flatten_dict(jax.device_get(params))
    updates = {}
    for name, dt in (("R", jnp.float32), ("J", jnp.bfloat16)):
        tx, _ = jax_build_optimizer(cfg, params)
        step_fn = jax.jit(jax_make_train_step(jmodel.clone(dtype=dt), tx))
        jp, opt_state = params, tx.init(params)
        for it in range(3):
            jp, opt_state, _ = step_fn(jp, opt_state, jimages, jgt,
                                       jax.random.PRNGKey(0), it)
        updates[name] = {}
        for path, value in traverse_util.flatten_dict(
                jax.device_get(jp)).items():
            pname, kind = jax_path_to_d2(path)
            updates[name][pname] = (
                _to_torch_layout(np.asarray(value), kind).astype(np.float64)
                - _to_torch_layout(np.asarray(initial[path]), kind))

    model = make()
    model.load_state_dict(state_dict_from_jax_params(params))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = build_optimizer(cfg, model)
    step = make_train_step(model, opt, build_scheduler(cfg, opt),
                           build_gradient_clipper(cfg), seed=0)
    for it in range(3):
        losses = step(images, gt, it)
        assert torch.isfinite(losses["total_loss"])
    moved = 0
    for name, param in model.named_parameters():
        got = param.detach().double().numpy() - before[name].double().numpy()
        r, j = updates["R"][name], updates["J"][name]
        if name.startswith(("backbone.stem.", "backbone.res2.")):
            assert not got.any() and not r.any() and not j.any(), name
            continue
        rule1(name, got, j, r)
        moved += 1
    assert moved > 20
