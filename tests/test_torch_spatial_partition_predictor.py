"""TPU.SPATIAL_PARTITION through the predictor: the port's partitioned
predictor against the JAX package's, S 4 against S 1, predict_batch
against calls, and the backbone's layers really run in bands; split from
tests/test_torch_spatial_partition.py so that each file is a small share
of one xdist worker."""

import pytest
import torch

import jax

from fewshotobjectdetection_imporove_via_text_feature_tpu.engine.predictor import (
    DefaultPredictor as JaxPredictor,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
    state_dict_from_jax_params,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    DefaultPredictor,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.models.backbone import (
    RESNET_STAGES,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.parallel import (
    spatial,
)
from tests.test_full_network_oracle import _perturb
from tests.test_predictor import _tiny_cfg as _jax_tiny_cfg
from tests.test_torch_spatial_partition import (  # noqa: F401
    _Layers,
    _image,
    _same_detections,
    _tiny,
)


def _jax_partitioned(meta):
    base = JaxPredictor(_tiny(_jax_tiny_cfg(), meta))
    params = _perturb(jax.device_get(base.params))
    cfg = _tiny(_jax_tiny_cfg(), meta)
    cfg.TPU.SPATIAL_PARTITION = 4
    return JaxPredictor(cfg, params=params), params


def _port(meta, bands, params):
    cfg = _tiny(get_cfg(), meta)
    cfg.TPU.SPATIAL_PARTITION = bands
    return DefaultPredictor(cfg, device="cpu",
                            state_dict=state_dict_from_jax_params(params))


@pytest.fixture(scope="module")
def flagship():
    jpred, params = _jax_partitioned("GeneralizedRCNN")
    return jpred, params


@pytest.mark.parametrize("meta", ["GeneralizedRCNN", "GeneralizedTextRCNN"])
def test_partitioned_predictor_matches_the_jax_package(meta, flagship):
    jpred, params = (flagship if meta == "GeneralizedRCNN"
                     else _jax_partitioned(meta))
    assert jpred.model.spatial_axis == "spatial"
    port = _port(meta, 4, params)
    assert port.model.spatial_devices == [torch.device("cpu")] * 4
    image = _image()
    ref = jpred(image)
    assert len(ref["boxes"]) > 5  # the comparison has teeth
    spatial.HALO.reset()
    _same_detections(port(image), ref)
    assert spatial.HALO.gathers == 1


def test_port_at_s4_equals_the_port_at_s1(flagship):
    _, params = flagship
    image = _image()
    whole = _port("GeneralizedRCNN", 1, params)
    assert whole.model.spatial_devices is None
    spatial.HALO.reset()
    ref = whole(image)
    assert spatial.HALO.gathers == 0  # S 1 runs the backbone whole
    _same_detections(_port("GeneralizedRCNN", 4, params)(image), ref)


def test_predict_batch_at_s2_equals_call(flagship):
    _, params = flagship
    port = _port("GeneralizedRCNN", 2, params)
    images = [_image(seed) for seed in (1, 2, 3)]
    spatial.HALO.reset()
    outs = port.predict_batch(images)
    assert spatial.HALO.gathers == 1  # one batch of 4 (3 padded up)
    for image, out in zip(images, outs):
        _same_detections(out, port(image))


def _record(pred, image):
    rec = _Layers(pred.model.backbone)
    with rec:
        pred(image)
    return rec.calls


@pytest.mark.parametrize("bands", [2, 4])
def test_backbone_really_runs_partitioned(bands, flagship):
    _, params = flagship
    image = _image()
    # each backbone layer's input height when the backbone runs whole
    full = {name: h for kind, name, h in
            _record(_port("GeneralizedRCNN", 1, params), image)
            if kind == "layer"}
    port = _port("GeneralizedRCNN", bands, params)
    spatial.HALO.reset()
    calls = _record(port, image)
    stats = spatial.HALO
    halo_layers = 2 + sum(RESNET_STAGES[14][:3])
    assert stats.halo_layers == stats.halo_layers_at_gather == halo_layers
    assert stats.exchanges >= (bands - 1) * halo_layers
    assert stats.gathers == 1

    c4 = port.model.res2_out_channels * 4
    gathers = [i for i, (kind, shape, n) in enumerate(calls)
               if kind == "cat" and n == bands and shape[1] == c4
               and shape[2] == 192 // 16]
    assert len(gathers) == 1, calls
    layers = [(i, name, h) for i, (kind, name, h) in enumerate(calls)
              if kind == "layer"]
    # every backbone layer ran once a band, all before the gather
    assert len(full) == 2 + 4 * sum(RESNET_STAGES[14][:3])
    assert len(layers) == bands * len(full)
    assert {name for _, name, _ in layers} == set(full)
    assert all(i < gathers[0] for i, _, _ in layers)
    # and on its band and halo only: at most 6 rows (the 7x7's) beyond an
    # even share of the rows it has when it runs whole, and fewer than those
    for _, name, h in layers:
        assert h <= -(-full[name] // bands) + 6, (name, h, full[name])
        assert h < full[name], (name, h, full[name])
    assert stats.max_extra_rows <= 6
    assert stats.max_input_rows <= max(
        r1 - r0 for r0, r1 in spatial.band_rows(192, bands)) + 6
