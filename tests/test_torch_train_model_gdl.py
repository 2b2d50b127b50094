"""The GDL contract of the port's training step: res4's gradient is the ROI
branch's scaled by BACKWARD_SCALE, and FREEZE_AT 3 sends no gradient
below res4; split from tests/test_torch_train_model.py so that each file
is a small share of one xdist worker."""

import jax
import torch

from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    GeneralizedRCNN,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
    GTInstances,
)
from tests.test_torch_model import inputs, port_images
from tests.test_torch_train_model import (  # noqa: F401
    gt_arrays,
    jax_params,
    port_gt,
    port_model,
    total_loss,
)


def _train_batch():
    canvas, hw, orig = inputs(True)
    return port_images(canvas, hw, orig), port_gt(*gt_arrays(hw))


def test_gdl_backbone_gradient_is_the_scaled_roi_branch():
    """lambda_rpn 0: the RPN losses send the backbone nothing; lambda_rcnn
    0.75: the backbone's gradient is 0.75 x that of the ROI losses through
    an undamped decouple layer."""
    _, params = jax_params()
    images, gt = _train_batch()

    def backbone_grads(model, keys):
        losses = model.forward_train(images, gt,
                                     torch.Generator().manual_seed(0))
        model.zero_grad(set_to_none=True)
        sum(losses[k] for k in keys).backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()
                if n.startswith("backbone.")}

    roi = ("loss_cls", "loss_box_reg")
    rpn = ("loss_rpn_cls", "loss_rpn_loc")
    model = port_model(params)  # lambda_rpn 0, lambda_rcnn 0.75
    assert model.rpn_backward_scale == 0.0
    assert model.roi_backward_scale == 0.75
    full = backbone_grads(model, roi + rpn)
    unit = backbone_grads(port_model(params, roi_backward_scale=1.0), roi)
    only_rpn = backbone_grads(port_model(params, rpn_backward_scale=0.0),
                              rpn)
    for name in full:
        assert not only_rpn[name].any(), name
        # the same backward pass with the 0.75 applied at the decouple
        # layer or after: equal up to float32 rounding
        scaled = 0.75 * unit[name]
        err = float((full[name] - scaled).abs().max())
        assert err <= 1e-5 * float(scaled.abs().max()), (name, err)
        assert full[name].abs().max() > 0, name


def test_freeze_at_3_sends_no_gradient_below_res4():
    _, params = jax_params()
    images, gt = _train_batch()
    model = port_model(params, freeze_at=3)
    total_loss(model.forward_train(images, gt)).backward()
    for name, p in model.named_parameters():
        if name.startswith(("backbone.stem.", "backbone.res2.",
                            "backbone.res3.")):
            assert p.grad is None, name
        elif name.startswith("backbone.res4."):
            assert p.grad is not None and p.grad.abs().max() > 0, name
