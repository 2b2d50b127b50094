"""The port's solver, training step, checkpoints and surgery against the JAX
package's, on the CPU, float32.

LR schedules at every warmup and step boundary (rtol 1e-5 and atol 1e-6 of
BASE_LR: the JAX schedule is float32, and 1 + cos(pi t) near its end loses
its digits); the frozen and
group masks of the base and gfsod configs, name by name; per-tensor norm and
value clipping (rtol 1e-6); surgery exactly; the port's checkpoint round
trip, resume and SIGTERM; and a JAX pickle checkpoint read without JAX.
The 3 SGD steps against the JAX ``make_train_step`` are in
``test_torch_solver_steps.py``.
"""

import datetime
import os
import pickle
import signal
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from flax import traverse_util

from fewshotobjectdetection_imporove_via_text_feature_tpu.checkpoint.checkpointer import (
    Checkpointer as JaxCheckpointer,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.checkpoint import (
    surgery as jax_surgery,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.solver.build import (
    _clip_each_param_norm,
    _path_masks,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.solver.build import (
    build_lr_scheduler as jax_build_lr_scheduler,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.solver.build import (
    build_optimizer as jax_build_optimizer,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    load_checkpoint_file,
    load_jax_checkpoint,
    reset_optimizer,
    state_dict_from_jax_params,
    surgery_randinit,
    surgery_remove,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint.convert import (
    jax_path_to_d2,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    Trainer,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.solver import (
    build_gradient_clipper,
    build_lr_scheduler,
    param_groups,
)
from tests.test_torch_model import inputs, port_images
from tests.test_torch_train_model import (
    gt_arrays,
    jax_params,
    port_gt,
    port_model,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(ROOT, "configs", "voc", "defrcn_det_r101_base1.yaml")
GFSOD = os.path.join(ROOT, "configs", "voc",
                     "defrcn_gfsod_r101_novelx_10shot_seedx.yaml")


def _cfg(path=None, **solver):
    cfg = get_cfg()
    if path:
        cfg.merge_from_file(path)
    for k, v in solver.items():
        cfg.SOLVER[k] = v
    return cfg


# ------------------------------------------------------------ schedules
@pytest.mark.parametrize("name,method,warmup", [
    ("WarmupMultiStepLR", "linear", 100),
    ("WarmupMultiStepLR", "constant", 100),
    ("WarmupMultiStepLR", "linear", 0),
    ("WarmupCosineLR", "linear", 100),
])
def test_lr_schedule_matches_jax_at_every_boundary(name, method, warmup):
    cfg = _cfg(BASE, LR_SCHEDULER_NAME=name, WARMUP_METHOD=method,
               WARMUP_ITERS=warmup)
    ours, ref = build_lr_scheduler(cfg), jax_build_lr_scheduler(cfg)
    marks = [0, warmup, *cfg.SOLVER.STEPS, cfg.SOLVER.MAX_ITER]
    steps = sorted({max(0, m + d) for m in marks for d in (-1, 0, 1)})
    for step in steps:
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-5,
                                   atol=1e-6 * cfg.SOLVER.BASE_LR,
                                   err_msg=f"step {step}")


# ----------------------------------------------------------------- masks
@pytest.mark.parametrize("path,freeze_all", [(BASE, False), (GFSOD, False),
                                              (BASE, True)])
def test_frozen_and_group_masks_match_jax(path, freeze_all):
    cfg = _cfg(path)
    if freeze_all:
        cfg.MODEL.BACKBONE.FREEZE = True
        cfg.MODEL.RPN.FREEZE = True
        cfg.MODEL.ROI_HEADS.FREEZE_FEAT = True
    _, params = jax_params()
    frozen, bias, regular, norm = (traverse_util.flatten_dict(m) for m in
                                   _path_masks(cfg, params))
    groups = {n: kind for kind, named in param_groups(cfg, port_model(params))
              .items() for n, _ in named}
    ours = dict(port_model(params).named_parameters())
    buffers = dict(port_model(params).named_buffers())
    seen = set()
    for path_, is_frozen in frozen.items():
        name, _ = jax_path_to_d2(path_)
        assert name is not None, path_
        if name in buffers:  # FrozenBN: frozen on both sides
            assert is_frozen, name
            continue
        seen.add(name)
        want = ("frozen" if is_frozen else "bias" if bias[path_]
                else "norm" if norm[path_] else "regular")
        assert regular[path_] == (want == "regular")
        assert groups.get(name, "frozen") == want, name
    assert seen == set(ours)
    frozen_names = set(ours) - set(groups)
    if freeze_all:  # the whole backbone, the RPN and res5
        assert frozen_names == {n for n in ours if n.startswith(
            ("backbone.", "proposal_generator.", "roi_heads.res5."))}
    elif path == BASE:  # FREEZE_AT 3: stem, res2, res3
        assert frozen_names == {n for n in ours if n.startswith(
            ("backbone.stem.", "backbone.res2.", "backbone.res3."))}
    else:  # FREEZE_AT 3 and ROI_HEADS.FREEZE_FEAT: res5 too
        assert {n for n in ours if n.startswith("roi_heads.res5.")} \
            <= frozen_names


# -------------------------------------------------------------- clipping
@pytest.mark.parametrize("clip_type,norm_type", [
    ("norm", 2.0), ("norm", float("inf")), ("value", 2.0),
])
def test_gradient_clipping_matches_jax(clip_type, norm_type):
    rng = np.random.RandomState(0)
    grads = {f"p{i}": (rng.randn(*shape) * scale).astype(np.float32)
             for i, (shape, scale) in enumerate(
                 [((16, 8), 1.0), ((40,), 0.01), ((3, 3, 4, 4), 5.0)])}
    if clip_type == "norm":
        tx = _clip_each_param_norm(0.5, norm_type)
    else:
        tx = optax.clip(0.5)
    ref, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                       tx.init(grads))
    cfg = get_cfg()
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = clip_type
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 0.5
    cfg.SOLVER.CLIP_GRADIENTS.NORM_TYPE = norm_type
    params = []
    for k in grads:
        p = torch.nn.Parameter(torch.zeros(grads[k].shape))
        p.grad = torch.from_numpy(grads[k].copy())
        params.append(p)
    build_gradient_clipper(cfg)(params)
    for p, k in zip(params, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


# the 3-SGD-step config (``test_torch_solver_steps.py``, the device
# preprocessing tests)
def _step_cfg(freeze_at=2, freeze_feat=False, weight_decay=1e-3):
    cfg = _cfg(BASE, BASE_LR=0.02, MOMENTUM=0.9, WEIGHT_DECAY=weight_decay,
               WEIGHT_DECAY_BIAS=weight_decay / 2, BIAS_LR_FACTOR=2.0,
               WARMUP_ITERS=2, WARMUP_FACTOR=0.1, STEPS=(2,), GAMMA=0.5)
    cfg.MODEL.BACKBONE.FREEZE_AT = freeze_at
    cfg.MODEL.ROI_HEADS.FREEZE_FEAT = freeze_feat
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 0.05
    return cfg


# --------------------------------------------------------------- surgery
def _predictor(num_classes, d=32, seed=0):
    rng = np.random.RandomState(seed)
    return {"roi_heads": {"box_predictor": {
        "cls_score": {"kernel": rng.randn(d, num_classes + 1).astype(
            np.float32), "bias": rng.randn(num_classes + 1).astype(
            np.float32)},
        "bbox_pred": {"kernel": rng.randn(d, 4 * num_classes).astype(
            np.float32), "bias": rng.randn(4 * num_classes).astype(
            np.float32)},
    }}}


@pytest.mark.parametrize("dataset,base,all_", [("voc", 15, 20),
                                               ("coco", 60, 80)])
def test_surgery_equals_jax_surgery(dataset, base, all_):
    params = _predictor(base)
    state = state_dict_from_jax_params(params)
    ref = state_dict_from_jax_params(
        jax_surgery.surgery_randinit(params, all_, dataset, seed=5))
    got = surgery_randinit(state, all_, dataset, seed=5)
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert got["roi_heads.box_predictor.cls_score.weight"].shape[0] == all_ + 1
    # remove and reset
    _, full = jax_params()
    removed = surgery_remove(state_dict_from_jax_params(full))
    jax_removed = state_dict_from_jax_params(
        jax_surgery.surgery_remove(full))
    assert set(removed) == set(jax_removed)
    assert not any("box_predictor" in k for k in removed)
    ckpt = {"model": state, "optimizer": {"x": 1}, "scheduler": {},
            "iteration": 900}
    assert reset_optimizer(ckpt) == {"model": state, "iteration": 0}


# ------------------------------------------------------------ checkpoints
def _tiny_cfg(out_dir, max_iter, period=2):
    cfg = get_cfg()
    cfg.merge_from_file(BASE)
    cfg.MODEL.WEIGHTS = ""
    cfg.MODEL.RESNETS.DEPTH = 14
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 8
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 16
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 4
    cfg.MODEL.BACKBONE.FREEZE_AT = 2
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 600
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 100
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.SEED = 4
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.SOLVER.MAX_ITER = max_iter
    cfg.SOLVER.CHECKPOINT_PERIOD = period
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.STEPS = (3,)
    return cfg


def _data():
    canvas, hw, orig = inputs(True)
    return [(port_images(canvas, hw, orig), port_gt(*gt_arrays(hw)))]


def test_sigterm_saves_and_stops_without_model_final(tmp_path):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers are installed from the main thread")
    trainer = Trainer(_tiny_cfg(tmp_path, 5, period=0), _data(),
                      device="cpu")

    def preempt(it):
        if it == 1:  # what a SIGTERM delivered now would run
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)

    trainer.hooks.append(preempt)
    before = signal.getsignal(signal.SIGTERM)
    trainer.train()
    assert trainer.preempted
    assert signal.getsignal(signal.SIGTERM) is before
    assert (tmp_path / "last_checkpoint").read_text() == "model_0000001.pth"
    assert not (tmp_path / "model_final.pth").exists()
    resumed = Trainer(_tiny_cfg(tmp_path, 5, period=0), _data(),
                      device="cpu")
    resumed.resume_or_load()
    assert resumed.start_iter == 2


def test_a_jax_pickle_checkpoint_loads_without_jax(tmp_path):
    _, params = jax_params()
    cfg = _step_cfg()
    tx, _ = jax_build_optimizer(cfg, params)
    JaxCheckpointer(str(tmp_path), backend="pickle").save(
        {"params": params, "opt_state": tx.init(params), "iteration": 7},
        "model_0000007")
    path = str(tmp_path / "model_0000007.ckpt")
    raw = load_checkpoint_file(path)
    assert raw["iteration"] == 7
    state = load_jax_checkpoint(path)
    ref = state_dict_from_jax_params(params)
    assert set(state) == set(ref)
    for k in ref:
        assert torch.equal(state[k], ref[k]), k
    model = port_model(params)
    model.load_state_dict(state)
    with pytest.raises(NotImplementedError, match="orbax"):
        load_checkpoint_file(str(tmp_path))
    # nothing but numpy and JAX-side containers unpickles
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(pickle.dumps({"params": datetime.date(2020, 1, 1)}))
    with pytest.raises(pickle.UnpicklingError):
        load_checkpoint_file(str(bad))


def test_training_options_not_ported_raise_with_their_roadmap_item(tmp_path):
    # orbax, a JAX library, stays refused (item 8); multi-device training
    # is ported: MODEL_PARALLEL must divide the world size (1 here) and
    # SPATIAL_PARTITION is a serving option, as in the JAX package
    for key, value, error, match in (
            ("MODEL_PARALLEL", 2, ValueError, "world size 1"),
            ("SPATIAL_PARTITION", 2, ValueError, "DefaultPredictor serving"),
            ("CHECKPOINT_BACKEND", "orbax", NotImplementedError,
             "ROADMAP.md Queue 1 item 8 ")):
        cfg = _tiny_cfg(tmp_path, 1)
        cfg.TPU[key] = value
        with pytest.raises(error, match=match):
            Trainer(cfg, _data(), device="cpu")
    cfg = _tiny_cfg(tmp_path, 1)
    cfg.MODEL.WEIGHTS = str(tmp_path / "R-101.pkl")  # missing: refused
    with pytest.raises(FileNotFoundError, match="R-101.pkl"):
        Trainer(cfg, _data(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(_tiny_cfg(tmp_path, 1), _data())
