"""The port's PCB (the torchvision R-101 and the Prototypical Calibration
Block) against the JAX package's, on the CPU, float32 on both sides.

* The network: the same synthetic torchvision-named state dict (the port's
  weight maker) loaded into both packages' TorchvisionResNet gives logits
  and res5 maps within 1e-4 relative; the port's module names are
  torchvision's, key for key the manifest.
* The block: on synthetic VOC from the port's maker, the JAX block with
  TEST.PCB_MODELPATH "" (its own random ResNet) and the port's block with
  those weights carried across give prototypes within 1e-4 and rescored
  scores within 1e-5 (the same detections in); the pad region does not
  reach a feature; image ids shared by two DATASETS.TEST entries are
  refused without file names, in both; the window (PCB_LOWER, PCB_UPPER]
  is half-open and excluded classes keep their scores, in both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fewshotobjectdetection_imporove_via_text_feature_tpu.checkpoint.torch_import import (
    apply_weight_dict as jax_apply_weight_dict,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.config import (
    get_cfg as jax_get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data import (
    DatasetCatalog as JaxDatasetCatalog,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data.builtin_meta import (
    _get_builtin_metadata as jax_builtin_metadata,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.data.meta_voc import (
    register_meta_voc as jax_register_meta_voc,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.evaluation.archs import (
    TorchvisionResNet as JaxTorchvisionResNet,
    torchvision_r101_manifest as jax_manifest,
    tv_translate,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.evaluation.pcb import (
    PrototypicalCalibrationBlock as JaxPCB,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint.torch_import import (
    apply_weight_dict,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
    DatasetCatalog,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data.builtin_meta import (
    _get_builtin_metadata,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.data.meta_voc import (
    register_meta_voc,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation.archs import (
    TorchvisionResNet,
    torchvision_r101_manifest,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
    pcb as pcb_module,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation.pcb import (
    PrototypicalCalibrationBlock,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align import (
    roi_align,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_voc import (
    make_voc,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_weights import (
    torchvision_r101_state,
)

PREFIX = "torchpcb_"
# train: the support set; test: two sets whose image ids collide
TRAIN = "voc_2007_trainval_all1"
TESTS = ("voc_2007_test_all1", "voc_2012_trainval_all1")


def _tv_name(path):
    """A JAX TorchvisionResNet param path -> (torchvision name, kind): the
    inverse of the JAX package's ``tv_translate``."""
    p = tuple(map(str, path))
    if p[0] in ("conv1", "bn1", "fc"):
        name = f"{p[0]}.{'weight' if p[1] == 'kernel' else p[1]}"
    else:
        layer, block, mod, leaf = p
        b = block[len("block"):]
        mod = {"shortcut": "downsample.0", "shortcut_bn": "downsample.1"}.get(
            mod, mod)
        name = f"{layer}.{b}.{mod}.{'weight' if leaf == 'kernel' else leaf}"
    back, kind = tv_translate(name)
    assert back == p, (path, name, back)
    return name, kind


def _to_port_state(params):
    """The JAX network's params as the port's (torchvision) state dict."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        name, kind = _tv_name([k.key for k in path])
        v = np.array(v, np.float32)
        if kind == "conv":
            v = v.transpose(3, 2, 0, 1)
        elif kind == "linear":
            v = v.T
        out[name] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def _jax_tree_shapes():
    return jax.eval_shape(JaxTorchvisionResNet(depth=101).init,
                          jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3), jnp.float32))["params"]


def test_module_names_are_the_torchvision_manifest():
    keys = list(TorchvisionResNet(101).state_dict())
    assert keys == torchvision_r101_manifest()
    assert sorted(keys) == sorted(jax_manifest())
    assert list(torchvision_r101_state(0)) == keys
    assert len(keys) == 522


def test_network_outputs_equal_the_jax_package():
    state = torchvision_r101_state(seed=0)
    port = TorchvisionResNet(101).eval()
    matched, skipped = apply_weight_dict(port, state, lambda n: n)
    assert (matched, skipped) == (522, [])
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   _jax_tree_shapes())
    params, jmatched, jskipped = jax_apply_weight_dict(
        zeros, {k: v.numpy() for k, v in state.items()}, tv_translate,
        strict=True)
    assert (jmatched, jskipped) == (522, [])
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
    logits, feat = jax.jit(JaxTorchvisionResNet(depth=101).apply)(
        {"params": params}, x)
    with torch.no_grad():
        tlogits, tfeat = port(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    logits, feat = np.asarray(logits), np.asarray(feat).transpose(0, 3, 1, 2)
    assert tfeat.shape == (2, 2048, 2, 3)
    for ours, theirs in ((tlogits.numpy(), logits), (tfeat.numpy(), feat)):
        rel = np.abs(ours - theirs).max() / np.abs(theirs).max()
        assert rel < 1e-4, rel


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    """(port block, JAX block) on the same synthetic VOC, the port's with
    the JAX block's random weights and its own prototypes rebuilt."""
    root = str(tmp_path_factory.mktemp("torchpcb"))
    # 7 images reach all 20 classes (3 objects an image, classes rotate);
    # 192x160 pads to 192x192, so every image has a pad region
    make_voc(root, images=7, image_size=(192, 160))
    meta, jmeta = (_get_builtin_metadata("voc_fewshot"),
                   jax_builtin_metadata("voc_fewshot"))
    for name in (TRAIN,) + TESTS:
        year = 2007 if "2007" in name else 2012
        split = "test" if "test" in name else "trainval"
        args = (f"{root}/VOC{year}", split, year, "base_novel_1", 1)
        if PREFIX + name not in DatasetCatalog:
            register_meta_voc(PREFIX + name, meta, *args, root=root)
        if PREFIX + name not in JaxDatasetCatalog:
            jax_register_meta_voc(PREFIX + name, jmeta, *args, root=root)
    cfgs = []
    for make in (get_cfg, jax_get_cfg):
        cfg = make()
        cfg.DATASETS.TRAIN = (PREFIX + TRAIN,)
        cfg.DATASETS.TEST = tuple(PREFIX + t for t in TESTS)
        cfg.TEST.PCB_MODELPATH = ""
        cfgs.append(cfg)
    cfgs[0].MODEL.DEVICE = "cpu"
    theirs = JaxPCB(cfgs[1])
    ours = PrototypicalCalibrationBlock(cfgs[0])
    ours.model.load_state_dict(_to_port_state(theirs.params))
    ours.prototypes = ours.build_prototypes()
    return ours, theirs


def _detections(pcb, n_images=3, d=8, seed=1):
    ids = sorted(pcb._files)[:n_images]
    rng = np.random.RandomState(seed)
    det = {
        "boxes": rng.uniform(5, 120, (n_images, d, 4)).astype(np.float32),
        "scores": rng.uniform(0.02, 0.98, (n_images, d)).astype(np.float32),
        # excluded base classes (< 15) beside novel ones
        "classes": rng.randint(10, 20, (n_images, d)).astype(np.int32),
        "valid": rng.uniform(size=(n_images, d)) < 0.9,
    }
    det["boxes"][..., 2:] += det["boxes"][..., :2]
    files = [DatasetCatalog.get(PREFIX + TESTS[0])[i]["file_name"]
             for i in range(n_images)]
    return ids, det, files


def test_prototypes_equal_the_jax_package(blocks):
    ours, theirs = blocks
    assert sorted(ours.prototypes) == sorted(theirs.prototypes) == list(
        range(20))
    for c, p in theirs.prototypes.items():
        # within 1e-4: float32 networks in two frameworks
        np.testing.assert_allclose(ours.prototypes[c], p, rtol=1e-4,
                                   atol=1e-4, err_msg=str(c))
    assert ours.exclude_cls == theirs.exclude_cls == list(range(15))


def test_rescored_scores_equal_the_jax_package(blocks, monkeypatch):
    ours, theirs = blocks
    ids, det, files = _detections(ours)
    pooled = []

    def counted(*args):
        pooled.append(args[1].shape)
        return roi_align(*args)

    monkeypatch.setattr(pcb_module, "roi_align", counted)
    got = ours.execute_calibration(
        ids, {k: v.copy() for k, v in det.items()}, file_names=files)
    want = theirs.execute_calibration(
        ids, {k: v.copy() for k, v in det.items()}, file_names=files)
    # within 1e-5: cosines of float32 vectors from two frameworks
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5,
                               atol=1e-5)
    moved = got["scores"] != det["scores"]
    novel = (det["classes"] >= 15) & det["valid"] & (det["scores"] > 0.05)
    assert moved.any() and not moved[~novel].any()
    # the three images share one padded size: one ROIAlign call, all boxes
    assert len(pooled) == 1 and pooled[0][0] == 3


def test_pad_region_does_not_reach_a_feature(blocks):
    ours, _ = blocks
    rng = np.random.RandomState(3)
    img = np.zeros((1, 128, 128, 3), np.uint8)
    img[0, :100, :90] = rng.randint(0, 255, (100, 90, 3), np.uint8)
    junk = img.copy()
    junk[0, 100:, :] = 255
    junk[0, :, 90:] = 137
    boxes = torch.tensor([[[60.0, 50.0, 89.0, 99.0]]])  # on the border
    hw = torch.tensor([[100, 90]], dtype=torch.int32)
    a = ours._extract(torch.from_numpy(img), boxes, hw)
    b = ours._extract(torch.from_numpy(junk), boxes, hw)
    assert torch.equal(a, b)


def test_shared_image_ids_need_file_names(blocks):
    ours, theirs = blocks
    # VOC2007 test and VOC2012 trainval share ids 000000..000006
    assert ours._ambiguous == theirs._ambiguous == set(
        f"{i:06d}" for i in range(7))
    ids, det, files = _detections(ours, n_images=1)
    for pcb in blocks:
        with pytest.raises(ValueError, match="multiple DATASETS.TEST"):
            pcb.execute_calibration(ids, {k: v.copy() for k, v in
                                          det.items()})


@pytest.mark.parametrize("exclude", [[], [0]])
def test_window_is_half_open_and_excluded_classes_keep_scores(exclude):
    """score == PCB_UPPER is rescored, score == PCB_LOWER is not; an
    excluded class and a class with no prototype keep their scores; both
    packages on the same stubbed features."""
    scores = np.array([0.95, 0.85, 0.5, 0.05, 0.6, 0.7], np.float32)
    classes = np.array([0, 0, 0, 0, 1, 2], np.int32)  # 2: no prototype
    feats = np.array([[1.0, 0, 0], [1, 1, 0], [0, 1, 0], [1, 0, 0],
                      [0, 0, 1], [1, 0, 0]], np.float32)
    out = []
    for cls in (PrototypicalCalibrationBlock, JaxPCB):
        pcb = object.__new__(cls)
        pcb.alpha, pcb.lower, pcb.upper = 0.5, 0.05, 0.85
        pcb.prototypes = {0: np.array([1.0, 0, 0], np.float32),
                          1: np.array([1.0, 0, 1], np.float32)}
        pcb.exclude_cls = exclude
        pcb._files, pcb._ambiguous = {1: "unused.jpg"}, set()
        pcb._roi_features_batch = lambda files, bl: [
            feats[[int(b[0]) for b in bx]] for bx in bl]
        det = {"boxes": np.arange(6, dtype=np.float32)[None, :, None]
               .repeat(4, 2),
               "scores": scores[None].copy(), "classes": classes[None],
               "valid": np.ones((1, 6), bool)}
        out.append(pcb.execute_calibration([1], det)["scores"][0])
    cos = [1.0, 1 / np.sqrt(2), 0.0, None, 1 / np.sqrt(2), None]
    want = scores.copy()
    for i in (1, 2, 4):
        if classes[i] not in exclude:
            want[i] = 0.5 * scores[i] + 0.5 * cos[i]
    np.testing.assert_allclose(out[0], want, rtol=1e-6)
    np.testing.assert_array_equal(out[0], out[1])
