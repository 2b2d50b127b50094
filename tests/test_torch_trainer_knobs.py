"""The JAX trainer's debugging and memory knobs on the port, on the CPU:
TPU.REMAT_BACKBONE (``torch.utils.checkpoint`` over the trainable backbone
stages: losses and gradients within 1e-6 of the run without it),
TPU.DEBUG_NANS (a non-finite loss or gradient raises
``FloatingPointError`` naming the step) and TPU.PROFILE_START_STEP /
PROFILE_NUM_STEPS (a ``torch.profiler`` trace under OUTPUT_DIR/profile; a
resume inside the window stops no trace it did not start)."""

import os

import numpy as np
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
from tests.test_torch_model import inputs, port_images
from tests.test_torch_train_model import (
    gt_arrays,
    jax_params,
    port_gt,
    port_model,
    total_loss,
)


def test_remat_backbone_gives_the_same_losses_and_gradients():
    _, params = jax_params()
    canvas, hw, orig = inputs(True)
    gt = port_gt(*gt_arrays(hw))
    runs = []
    for remat in (False, True):
        model = port_model(params, remat_backbone=remat)
        assert model.backbone.remat == remat
        losses = model.forward_train(port_images(canvas, hw, orig), gt,
                                     torch.Generator().manual_seed(0))
        total_loss(losses).backward()
        runs.append((losses, {n: p.grad for n, p in model.named_parameters()
                              if p.grad is not None}))
    (l0, g0), (l1, g1) = runs
    for k in l0:
        np.testing.assert_allclose(l1[k].item(), l0[k].item(), rtol=1e-6,
                                   err_msg=k)
    assert set(g0) == set(g1)
    assert any(n.startswith("backbone.res2") for n in g1)
    for n in g0:
        scale = float(g0[n].abs().max())
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=0,
                                   atol=1e-6 * max(scale, 1e-30), err_msg=n)


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


def _traces(out):
    d = os.path.join(out, "profile")
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def test_profile_window_writes_a_trace_and_a_resume_inside_it_does_not(
        tmp_path):
    cfg = _tiny_cfg(tmp_path / "a", 4, period=0)
    cfg.TPU.PROFILE_START_STEP = 1
    cfg.TPU.PROFILE_NUM_STEPS = 2
    Trainer(cfg, _data(), device="cpu").train()
    assert _traces(cfg.OUTPUT_DIR) == ["trace_to_iter_0000002.json"]
    assert os.path.getsize(os.path.join(
        cfg.OUTPUT_DIR, "profile", "trace_to_iter_0000002.json")) > 0

    # two steps, then a resume at step 2 inside the window 1..3: the
    # resumed run started no trace, so it stops none and writes none
    out = tmp_path / "b"
    Trainer(_tiny_cfg(out, 2), _data(), device="cpu").train()
    cfg = _tiny_cfg(out, 4, period=0)
    cfg.TPU.PROFILE_START_STEP = 1
    cfg.TPU.PROFILE_NUM_STEPS = 3
    resumed = Trainer(cfg, _data(), device="cpu")
    resumed.resume_or_load()
    assert resumed.start_iter == 2
    resumed.train()
    assert _traces(cfg.OUTPUT_DIR) == []

    # a window that runs past the last step is stopped at the end
    cfg = _tiny_cfg(tmp_path / "c", 2, period=0)
    cfg.TPU.PROFILE_START_STEP = 1
    cfg.TPU.PROFILE_NUM_STEPS = 5
    Trainer(cfg, _data(), device="cpu").train()
    assert _traces(cfg.OUTPUT_DIR) == ["trace_to_iter_0000001.json"]
