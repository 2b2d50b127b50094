"""The JAX trainer's debugging and memory knobs on the port, on the CPU:
TPU.REMAT_BACKBONE (``torch.utils.checkpoint`` over the trainable backbone
stages: losses and gradients within 1e-6 of the run without it),
TPU.DEBUG_NANS (a non-finite loss or gradient raises
``FloatingPointError`` naming the step) and TPU.PROFILE_START_STEP /
PROFILE_NUM_STEPS (a ``torch.profiler`` trace under OUTPUT_DIR/profile; a
resume inside the window stops no trace it did not start)."""

import pytest
import torch

from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    Trainer,
    make_train_step,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.solver import (
    build_optimizer,
)
from test_torch_solver import _data, _tiny_cfg
from tests.test_torch_train_model import jax_params, port_model, total_loss


def test_debug_nans_raises_naming_the_step():
    _, params = jax_params()
    model = port_model(params)
    opt = build_optimizer(_tiny_cfg("unused", 1), model)
    (images, gt), = _data()
    step = make_train_step(model, opt, seed=0, debug_nans=True)
    losses = step(images, gt, 0)  # finite: no error
    assert torch.isfinite(losses["total_loss"])
    with torch.no_grad():
        model.roi_heads.box_predictor.bbox_pred.weight[0, 0] = float("nan")
    before = model.roi_heads.box_predictor.cls_score.weight.detach().clone()
    with pytest.raises(FloatingPointError, match="step 7: non-finite"):
        step(images, gt, 7)
    # the check comes before the update
    assert torch.equal(model.roi_heads.box_predictor.cls_score.weight,
                       before)


def test_debug_nans_option_reaches_the_trainer(tmp_path):
    cfg = _tiny_cfg(tmp_path, 2, period=0)
    cfg.TPU.DEBUG_NANS = True
    (images, gt), = _data()
    bad = images.image.clone()
    bad[0, 0, 0, 0] = float("nan")
    trainer = Trainer(cfg, [(type(images)(bad, images.hw, images.orig_hw),
                             gt)], device="cpu")
    with pytest.raises(FloatingPointError, match="step 0"):
        trainer.train()


