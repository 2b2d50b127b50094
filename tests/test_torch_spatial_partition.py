"""TPU.SPATIAL_PARTITION on the port, on the CPU, float32, at the tiny size
of tests/test_predictor.py: one image's backbone in S row bands with a halo
exchange before every layer that reads neighbouring rows, res4 gathered
before the RPN.

  (a) banded res4 against the unsplit backbone's, within 1e-5 of res4's
      largest magnitude, for S 2-4, depth 14 and 26, the stride on the 1x1
      and on the 3x3, and buckets whose res4 rows S does not divide;
  (b) the port's DefaultPredictor at S 4 against the JAX package's
      partitioned DefaultPredictor (S 4 on its 8 host devices) at that
      package's own tolerances (same count, scores atol 1e-5, classes
      equal, boxes atol 1e-3), for the flagship and GeneralizedTextRCNN;
      the port at S 4 against itself at S 1; predict_batch at S 2 against
      __call__;
  (c) the backbone really runs partitioned: enough halo exchanges, no
      banded layer fed more than its band and halo, res4 gathered once
      after every backbone layer (an input gather followed by a whole-image
      backbone fails this);
  (d) the refusals: more bands than res4 rows, fewer CUDA devices than S,
      more than one process.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    init_weights,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    DefaultPredictor,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    predictor as predictor_mod,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models.backbone import (
    RESNET_STAGES,
    ResNetC4,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.parallel import (
    spatial,
)


def _tiny(cfg, meta="GeneralizedRCNN"):
    """tests/test_predictor.py's tiny cfg on either package's config."""
    cfg.MODEL.WEIGHTS = ""
    cfg.MODEL.RESNETS.DEPTH = 14
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 8
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 16
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 4
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 16
    cfg.TPU.IMAGE_BUCKETS = ((192, 256),)
    cfg.TPU.MAX_DETECTIONS_PRE_NMS = 64
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.INPUT.MIN_SIZE_TEST = 192
    cfg.INPUT.MAX_SIZE_TEST = 256
    cfg.MODEL.META_ARCHITECTURE = meta
    # five class names for the text bank (synthetic vectors, the same in
    # both packages)
    cfg.DATASETS.TRAIN = ("voc_2007_trainval_novel1",)
    return cfg


def _image(seed=1):
    return np.random.RandomState(seed).randint(0, 255, (230, 310, 3),
                                               dtype=np.uint8)  # BGR


def _same_detections(out, ref):
    """The JAX package's tests/test_spatial_partition.py tolerances."""
    assert len(out["boxes"]) == len(ref["boxes"])
    np.testing.assert_allclose(out["scores"], ref["scores"], atol=1e-5)
    np.testing.assert_array_equal(out["classes"], ref["classes"])
    np.testing.assert_allclose(out["boxes"], ref["boxes"], atol=1e-3)


# ------------------------------------------------------------------- (a)
def _backbone(depth, stride_in_1x1):
    bb = ResNetC4(depth=depth, stem_out_channels=8, res2_out_channels=16,
                  width_per_group=4, stride_in_1x1=stride_in_1x1)
    init_weights(bb, torch.Generator().manual_seed(depth))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # FrozenBN and conv3 away from their identities
        for name, t in bb.state_dict().items():
            if name.endswith(("norm.weight", "running_var")):
                t.uniform_(0.5, 1.5, generator=gen)
            elif name.endswith(("norm.bias", "running_mean")):
                t.normal_(0.0, 0.1, generator=gen)
            elif name.endswith("conv3.weight"):
                t.normal_(0.0, 0.05, generator=gen)
    return bb.eval()


# the grid of test_banded_res4_equals_unsplit; depth 26 runs in
# tests/test_torch_spatial_partition_deep{,_b}.py, one stride each (each
# file a small share of one xdist worker)
HW = dict(argnames="hw", argvalues=[(192, 256), (224, 320)],
          ids=["192x256", "224x320"])
BANDS = dict(argnames="bands", argvalues=[2, 3, 4])


@pytest.mark.parametrize(**HW)
@pytest.mark.parametrize("stride_in_1x1", [True, False],
                         ids=["stride1x1", "stride3x3"])
@pytest.mark.parametrize("depth", [14])
@pytest.mark.parametrize(**BANDS)
def test_banded_res4_equals_unsplit(bands, depth, stride_in_1x1, hw):
    check_banded(bands, depth, stride_in_1x1, hw)


def check_banded(bands, depth, stride_in_1x1, hw):
    bb = _backbone(depth, stride_in_1x1)
    x = torch.from_numpy(np.random.RandomState(bands).normal(
        0, 50, (2, 3, *hw)).astype(np.float32))
    with torch.no_grad():
        ref = bb(x)["res4"]
        spatial.HALO.reset()
        got = spatial.banded_backbone(bb, x, [torch.device("cpu")] * bands)
    assert got.shape == ref.shape == (2, 64, -(-hw[0] // 16), hw[1] // 16)
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    # stem conv, max-pool and every block's 3x3
    assert spatial.HALO.halo_layers == 2 + sum(RESNET_STAGES[depth][:3])
    assert spatial.HALO.gathers == 1


@pytest.mark.parametrize("height,bands,res4", [
    (800, 4, (13, 13, 12, 12)), (224, 3, (5, 5, 4)), (200, 2, (7, 6)),
    (192, 12, (1,) * 12)])
def test_band_plan(height, bands, res4):
    """Bands start on multiples of 16, share the res4 rows evenly (the
    first take one more) and end at the image's last row."""
    rows = spatial.band_rows(height, bands)
    assert [r0 % 16 for r0, _ in rows] == [0] * bands
    assert rows[0][0] == 0 and rows[-1][1] == height
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert tuple(-(-(r1 - r0) // 16) for r0, r1 in rows) == res4


@pytest.mark.parametrize("kernel,stride,padding,above,below", [
    (7, 2, 3, 3, 2), (3, 2, 1, 1, 0), (3, 1, 1, 1, 1), (1, 2, 0, 0, -1)])
def test_halo_rows_follow_from_the_layer(kernel, stride, padding, above,
                                         below):
    """A middle band starting on an even row takes ``padding`` rows from
    the band above and k - p - s from the band below (a strided 1x1 drops
    its band's last row); the rows beyond the image are ``fill``."""
    xs = [torch.arange(r0, r1, dtype=torch.float32).reshape(1, 1, -1, 1)
          for r0, r1 in ((0, 16), (16, 32), (32, 48))]
    rows = [(0, 16), (16, 32), (32, 48)]
    ins, new, out_h = spatial.halo_input(xs, rows, 48, kernel, stride,
                                         padding, fill=-1.0)
    assert out_h == (48 + 2 * padding - kernel) // stride + 1
    mid = ins[1].flatten().tolist()
    assert mid == list(range(16 - above, 32 + below))
    assert ins[0].flatten().tolist()[:padding] == [-1.0] * padding
    assert new[1] == (16 // stride, 32 // stride)


# ------------------------------------------------------------------- (b)


# ------------------------------------------------------------------- (c)
class _Layers(TorchFunctionMode):
    """Records every convolution of ``backbone`` (its weight's name) and
    every max-pool with its input's height, and every concatenation along
    H (its output's shape and its number of inputs), in call order."""

    def __init__(self, backbone):
        super().__init__()
        self.names = {p.data_ptr(): n
                      for n, p in backbone.named_parameters()}
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is F.conv2d and args[1].data_ptr() in self.names:
            self.calls.append(("layer", self.names[args[1].data_ptr()],
                               args[0].shape[2]))
        elif getattr(func, "__name__", "") in ("_max_pool2d", "max_pool2d"):
            self.calls.append(("layer", "max_pool", args[0].shape[2]))
        elif func is torch.cat and kwargs.get(
                "dim", args[1] if len(args) > 1 else 0) == 2:
            self.calls.append(("cat", tuple(out.shape), len(args[0])))
        return out


def test_band_modules_copy_the_backbone_once_a_device():
    """Bands on the backbone's device run the backbone itself; another
    device gets one copy, made at the first call and kept."""
    bb = _backbone(14, True)
    mods = spatial.band_modules(bb, ["cpu", "meta", "meta"])
    assert mods[0] is bb and mods[1] is mods[2] and mods[1] is not bb
    assert {p.device.type for p in mods[1].parameters()} == {"meta"}
    assert spatial.band_modules(bb, ["cpu", "meta"])[1] is mods[1]


def test_banded_backbone_serves_only():
    bb = _backbone(14, True)
    x = torch.zeros(1, 3, 64, 64)
    with pytest.raises(RuntimeError, match="SPATIAL_PARTITION"):
        spatial.banded_backbone(bb, x, [torch.device("cpu")] * 2)


# ------------------------------------------------------------------- (d)
def test_refuses_more_bands_than_res4_rows():
    cfg = _tiny(get_cfg())
    cfg.TPU.SPATIAL_PARTITION = 13  # the 192-row bucket has 12 res4 rows
    with pytest.raises(ValueError, match="TPU.SPATIAL_PARTITION 13"):
        DefaultPredictor(cfg, device="cpu")
    with pytest.raises(ValueError, match="SPATIAL_PARTITION"):
        spatial.band_rows(192, 13)


def test_refuses_fewer_cuda_devices_than_bands(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cfg = _tiny(get_cfg())
    cfg.TPU.SPATIAL_PARTITION = 2
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        DefaultPredictor(cfg, device="cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert predictor_mod.spatial_devices(cfg, torch.device("cuda")) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]


def test_refuses_more_than_one_process(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    cfg = _tiny(get_cfg())
    cfg.TPU.SPATIAL_PARTITION = 2
    with pytest.raises(ValueError, match="single-process only"):
        DefaultPredictor(cfg, device="cpu")
