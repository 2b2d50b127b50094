"""3 SGD steps of the port's tiny model against the JAX package's
``make_train_step`` on the CPU, float32, from the same weights and batch,
under each gradient contract (base, gfsod, the gate's sabotaged arm): each
parameter's update within 1e-4 of the update's largest value, the frozen
parameters unmoved on both sides.
"""

import numpy as np
import pytest

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
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    GTInstances as JaxGT,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint.convert import (
    _to_torch_layout,
    jax_path_to_d2,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    make_train_step,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.solver import (
    build_gradient_clipper,
    build_lr_scheduler,
    build_optimizer,
    build_scheduler,
)
from test_torch_solver import _step_cfg
from tests.test_torch_model import inputs, jax_images, port_images
from tests.test_torch_train_model import (
    gt_arrays,
    jax_params,
    port_gt,
    port_model,
)

# ------------------------------------------------------- 3 SGD steps
# the gradient contracts: (FREEZE_AT, ROI_HEADS.FREEZE_FEAT, GDL lambda_rpn,
# lambda_rcnn, the parameters the optimizer never moves, WEIGHT_DECAY).
# "base": the base config's scales at FREEZE_AT 2; "gfsod": the gfsod
# config's contract at the held-out gate's profile (FREEZE_AT 0);
# "sabotaged": the gate's sabotaged arm (full backward, res5 trained). The
# gfsod case runs without weight decay: its backbone's updates are
# lambda_rcnn 0.001 of a gradient, as small as a decay of 1e-3, and the two
# would partly cancel, so the net update would show the gradient's float32
# reassociation noise magnified; without decay the update is the gradient
# contract's own
STEP_CONTRACTS = {
    "base": (2, False, 0.0, 0.75, ("backbone.stem.", "backbone.res2."),
             1e-3),
    "gfsod": (0, True, 0.0, 0.001, ("roi_heads.res5.",), 0.0),
    "sabotaged": (0, False, 1.0, 1.0, (), 1e-3),
}


# the gfsod and sabotaged contracts run in
# tests/test_torch_solver_steps_{gfsod,sabotaged}.py (each file a small
# share of one xdist worker)
@pytest.mark.parametrize("contract", ["base"])
def test_three_sgd_steps_match_jax_make_train_step(contract):
    check_three_steps(contract)


def check_three_steps(contract):
    freeze_at, freeze_feat, rpn_scale, roi_scale, frozen, decay = \
        STEP_CONTRACTS[contract]
    cfg = _step_cfg(freeze_at, freeze_feat, decay)
    jmodel, params = jax_params()
    jmodel = jmodel.clone(rpn_backward_scale=rpn_scale,
                          roi_backward_scale=roi_scale)
    canvas, hw, orig = inputs(True)
    gb, gc, gv = gt_arrays(hw)

    tx, _ = jax_build_optimizer(cfg, params)
    step_fn = jax.jit(jax_make_train_step(jmodel, tx))
    jp, opt_state = params, tx.init(params)
    jgt = JaxGT(jnp.asarray(gb), jnp.asarray(gc), jnp.asarray(gv))
    for it in range(3):
        jp, opt_state, _ = step_fn(jp, opt_state,
                                   jax_images(canvas, hw, orig), jgt,
                                   jax.random.PRNGKey(0), it)

    model = port_model(params, rpn_backward_scale=rpn_scale,
                       roi_backward_scale=roi_scale)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = build_optimizer(cfg, model)
    step = make_train_step(model, opt, build_scheduler(cfg, opt),
                           build_gradient_clipper(cfg), seed=0)
    images, gt = port_images(canvas, hw, orig), port_gt(gb, gc, gv)
    lrs = []
    for it in range(3):
        lrs.append(opt.param_groups[0]["lr"])
        losses = step(images, gt, it)
        assert torch.isfinite(losses["total_loss"])
    np.testing.assert_allclose(lrs, [build_lr_scheduler(cfg)(i)
                                     for i in range(3)], rtol=1e-12)

    # each parameter's 3-step update (final minus initial, in float64) within
    # 1e-4 of that update's largest value: the weight-decay terms (about
    # 3e-5 of a weight, 3e-6 of a bias) are 0.3-3% of the updates, far above
    # that, where a comparison of the parameters themselves would miss them
    initial = traverse_util.flatten_dict(jax.device_get(params))
    named = dict(model.named_parameters())
    moved = 0
    for path, value in traverse_util.flatten_dict(jax.device_get(jp)).items():
        name, kind = jax_path_to_d2(path)
        param = named.get(name)
        if param is None:  # FrozenBN statistics: buffers here
            continue
        want = _to_torch_layout(np.asarray(value), kind).astype(np.float64) \
            - _to_torch_layout(np.asarray(initial[path]), kind)
        got = param.detach().double().numpy() - before[name].double().numpy()
        if frozen and name.startswith(frozen):
            assert not got.any() and not want.any(), name  # frozen
            continue
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
        moved += scale > 0
    assert moved > 20
