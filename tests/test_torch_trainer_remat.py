"""TPU.REMAT_BACKBONE gives the same losses and gradients as a step without
it; split from tests/test_torch_trainer_knobs.py so that each file is a
small share of one xdist worker."""

import numpy as np
import torch

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
