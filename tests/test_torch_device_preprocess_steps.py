"""Two SGD steps on raw batches with TPU.DEVICE_PREPROCESS against the JAX
package's make_train_step; split from
tests/test_torch_device_preprocess.py so that each file is a small share
of one xdist worker."""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from fewshotobjectdetection_imporove_via_text_feature_tpu.data.mapper import (
    resize_shortest_edge_size,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.engine.trainer import (
    make_train_step as jax_make_train_step,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.solver import (
    build_optimizer as jax_build_optimizer,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    GTInstances as JaxGT,
    ImageBatch as JaxImageBatch,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
    build_detection_test_loader,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data.device_preprocess import (
    device_resize_batch,
    scale_boxes,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    make_train_step,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
    inference_on_dataset,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    build_model,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.solver import (
    build_gradient_clipper,
    build_optimizer,
    build_scheduler,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
    ImageBatch,
)
from test_torch_eval_cli import (  # noqa: F401  (voc is a fixture)
    PREFIX,
    TEST_SET,
    _Recorder,
    _tiny_cfgs,
    voc,
)
from test_torch_solver import _step_cfg
from tests.test_torch_device_preprocess import _raw_batch
from tests.test_torch_model import H, W
from tests.test_torch_train_model import jax_params, port_gt, port_model


def test_two_sgd_steps_on_raw_batches_match_jax_make_train_step():
    cfg = _step_cfg()
    jmodel, params = jax_params()
    raw, hw, orig, short, flip, (gb, gc, gv) = _raw_batch()
    assert (hw <= (H, W)).all()

    tx, _ = jax_build_optimizer(cfg, params)
    step_fn = jax.jit(jax_make_train_step(jmodel, tx, preprocess=(W, (H, W))))
    jp, opt_state = params, tx.init(params)
    jimages = JaxImageBatch(image=jnp.asarray(raw), hw=jnp.asarray(hw),
                            orig_hw=jnp.asarray(orig))
    jgt = JaxGT(jnp.asarray(gb), jnp.asarray(gc), jnp.asarray(gv))
    ref = []
    for it in range(2):
        jp, opt_state, losses = step_fn(jp, opt_state, jimages, jgt,
                                        jax.random.PRNGKey(0), it,
                                        jnp.asarray(short), jnp.asarray(flip))
        ref.append(jax.device_get(losses))

    model = port_model(params)
    opt = build_optimizer(cfg, model)
    step = make_train_step(model, opt, build_scheduler(cfg, opt),
                           build_gradient_clipper(cfg), seed=0)
    images = ImageBatch(torch.from_numpy(raw), torch.from_numpy(hw),
                        torch.from_numpy(orig))
    meta = {"short": short, "flip": flip, "target_hw": (H, W),
            "max_size": W}
    for it in range(2):
        losses = step(images, port_gt(gb, gc, gv), it, meta)
        assert losses["loss_box_reg"].item() > 0
        for k, want in ref[it].items():
            np.testing.assert_allclose(losses[k].item(), float(want),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
