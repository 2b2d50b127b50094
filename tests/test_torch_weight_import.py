"""The port's weight import against the JAX package's, on the CPU.

A narrow detector of the real R-101 depth (every one of the 33 blocks has
names) starts from the same seeded tree in both packages; each synthetic
file is loaded into both, and the port's state dict must equal the JAX
tree after ``export_d2_state`` exactly (the same float32 values copied),
with the same matched count and the same skipped names. The files: a
Caffe2 pickle with every R-101 blob (plus the classifier and momentum
blobs a detector does not read), a detectron2 ``.pth`` with tensors, the
same with numpy arrays, and one whose ``cls_score`` has the base classes'
shape. The JAX package's ``.pth`` reader keeps only entries with a
``.numpy()`` method (tensors), so the numpy-valued file is held to the
JAX load of the tensor-valued one.
"""

import functools
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fewshotobjectdetection_imporove_via_text_feature_tpu.checkpoint.torch_import import (
    export_d2_state,
    load_reference_weights as jax_load_reference_weights,
    maybe_load_reference_weights as jax_maybe_load,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.models import (
    GeneralizedRCNN as JaxRCNN,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.structures import (
    ImageBatch as JaxImageBatch,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    load_reference_weights,
    maybe_load_reference_weights,
    state_dict_from_jax_params,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint.torch_import import (
    c2_to_d2,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
    GeneralizedRCNN,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(num_classes=5, depth=101, stem_out_channels=8, res2_out_channels=16,
          width_per_group=4, freeze_at=0, rpn_pre_nms_topk=(64, 64),
          rpn_post_nms_topk=(16, 16), test_candidate_topk=32)


@pytest.fixture(scope="module")
def start():
    """The JAX tree (shapes from tracing the init, values from a seed)."""
    model = JaxRCNN(**KW)
    images = JaxImageBatch(image=jnp.zeros((1, 64, 64, 3)),
                           hw=jnp.asarray([[64, 64]], jnp.int32),
                           orig_hw=jnp.asarray([[64, 64]], jnp.int32))
    shapes = jax.eval_shape(
        functools.partial(model.init, train=False),
        {"params": jax.random.PRNGKey(0)}, images)["params"]
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _port(params):
    model = GeneralizedRCNN(**KW)
    model.load_state_dict(state_dict_from_jax_params(params))
    return model


def _c2_blobs(port):
    """Every Caffe2 blob of this R-101, named by inverting ``c2_to_d2`` over
    the port's names, with seeded values; plus blobs no detector reads."""
    state = port.state_dict()
    rng = np.random.RandomState(1)
    names = ["conv1_w", "res_conv1_bn_s", "res_conv1_bn_b"]
    for stage, n in zip(("res2", "res3", "res4", "res5"), (3, 4, 23, 3)):
        for b in range(n):
            for branch in ("branch2a", "branch2b", "branch2c", "branch1"):
                if branch == "branch1" and b:
                    continue
                names += [f"{stage}_{b}_{branch}{s}"
                          for s in ("_w", "_bn_s", "_bn_b")]
    blobs = {name: rng.standard_normal(
        tuple(state[c2_to_d2(name)].shape)).astype(np.float32)
        for name in names}
    assert len(blobs) == 312
    blobs["pred_w"] = rng.standard_normal((10, 8)).astype(np.float32)
    blobs["res2_0_branch2a_w_momentum"] = blobs["res2_0_branch2a_w"] * 0
    blobs["res2_0_branch3a_w"] = np.zeros(4, np.float32)  # no such branch
    return blobs


def _d2_state(start, cls_rows=None):
    """A detectron2 state dict: the JAX exporter's names and layouts, new
    seeded values, and names the flagship has no tensor for."""
    state, _, skipped = export_d2_state(start)
    assert not skipped
    rng = np.random.RandomState(2)
    state = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in state.items()}
    if cls_rows is not None:  # a base model's cls_score into this one
        key = "roi_heads.box_predictor.cls_score.weight"
        state[key] = rng.standard_normal(
            (cls_rows, state[key].shape[1])).astype(np.float32)
    state["roi_heads.stu_box_predictor.cls_score.weight"] = np.zeros(
        (6, 4), np.float32)
    state["backbone.res2.0.conv1.norm.num_batches_tracked"] = np.zeros(
        (), np.float32)
    state["pixel_mean"] = np.zeros((3, 1, 1), np.float32)
    return state


def _write(tmp_path, name, case, start):
    path = str(tmp_path / name)
    if case == "c2_pkl":
        with open(path, "wb") as f:
            pickle.dump({"blobs": _c2_blobs(_port(start))}, f)
        return path
    state = _d2_state(start, 4 if case == "d2_cls_mismatch" else None)
    if case != "d2_numpy":
        state = {k: torch.from_numpy(v) for k, v in state.items()}
    torch.save({"model": state, "iteration": 7, "__author__": "synthetic"},
               path)
    return path


def _assert_equal(port, params):
    theirs, _, _ = export_d2_state(params)
    ours = {k: v.numpy() for k, v in port.state_dict().items()}
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


# exact equality: both packages copy the same float32 values
@pytest.mark.parametrize("case,suffix", [
    ("c2_pkl", ".pkl"), ("d2_tensor", ".pth"), ("d2_numpy", ".pth"),
    ("d2_cls_mismatch", ".pth")])
def test_loaded_weights_equal_the_jax_package(start, tmp_path, case,
                                              suffix):
    path = _write(tmp_path, case + suffix, case, start)
    port = _port(start)
    matched, skipped = load_reference_weights(path, port)
    # the JAX package's .pth reader drops numpy values: its reference for
    # the numpy-valued file is the tensor-valued file with the same values
    ref_path = path if case != "d2_numpy" else _write(
        tmp_path, "d2_tensor.pth", "d2_tensor", start)
    new, jmatched, jskipped = jax_load_reference_weights(ref_path, start)
    _assert_equal(port, new)
    assert matched == jmatched
    assert sorted(skipped) == sorted(jskipped)
    if case == "c2_pkl":
        assert matched == 312
        assert sorted(skipped) == ["pred_w", "res2_0_branch3a_w"]
    else:
        want = {"roi_heads.stu_box_predictor.cls_score.weight",
                "backbone.res2.0.conv1.norm.num_batches_tracked",
                "pixel_mean"}
        if case == "d2_cls_mismatch":
            want.add("roi_heads.box_predictor.cls_score.weight")
        assert set(skipped) == want
    # the port's loaded tensors are the file's, and what the file lacks
    # kept its starting value
    if case == "c2_pkl":
        with open(path, "rb") as f:
            blobs = pickle.load(f)["blobs"]
        np.testing.assert_array_equal(
            port.state_dict()["roi_heads.res5.2.conv3.norm.weight"].numpy(),
            blobs["res5_2_branch2c_bn_s"])
        np.testing.assert_array_equal(
            port.state_dict()["backbone.res4.0.conv1.norm.running_var"]
            .numpy(),
            start["backbone"]["res4"]["block0"]["bn1"]["running_var"])


def test_missing_weights_raise_in_both_packages(start, tmp_path):
    missing = str(tmp_path / "R-101.pkl")
    with pytest.raises(FileNotFoundError):
        maybe_load_reference_weights(missing, _port(start))
    with pytest.raises(FileNotFoundError):
        jax_maybe_load(missing, start)
    # "" loads nothing
    port = _port(start)
    assert maybe_load_reference_weights("", port) is port


def test_synthetic_c2_file_covers_the_full_width_detector(tmp_path):
    """The port's weight maker writes every blob of a Caffe2 R-101 under its
    real name; into the base config's detector at full width, every
    backbone and res5 convolution and FrozenBN scale and shift is loaded,
    and only the ImageNet classifier is left over."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        build_model,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_weights import (
        write_c2_pkl,
    )

    path = str(tmp_path / "R-101.pkl")
    blobs = write_c2_pkl(path, seed=0)
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "voc",
                                     "defrcn_det_r101_base1.yaml"))
    model = build_model(cfg)
    matched, skipped = load_reference_weights(path, model)
    assert (matched, sorted(skipped)) == (312, ["pred_b", "pred_w"])
    state = model.state_dict()
    targets = [k for k in state
               if k.startswith(("backbone.", "roi_heads.res5."))
               and not k.endswith(("running_mean", "running_var"))]
    assert len(targets) == 312
    loaded = {c2_to_d2(n): v for n, v in blobs.items() if c2_to_d2(n)}
    for k in targets:
        np.testing.assert_array_equal(state[k].numpy(), loaded[k], err_msg=k)
