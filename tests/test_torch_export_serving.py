"""The port's serving export (``engine/export.py``) on the CPU, a case for
each case of tests/test_export_serving.py: the artifact's contents (one
copy of the weights), multi-batch ``predict_batch``, ``ServingPredictor``
bitwise equal to the port's ``DefaultPredictor`` and within 1e-4 of the
JAX package's ``ServingPredictor`` on the same weights and images, the
contract errors, the operators in the programs, and a text family."""

import io
import json
import zipfile

import numpy as np
import pytest

import jax

from fewshotobjectdetection_imporove_via_text_feature_tpu.config import (
    get_cfg as jax_get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.engine.export import (
    ServingPredictor as JaxServingPredictor,
    export_inference as jax_export_inference,
    save_serving_artifact as jax_save_serving_artifact,
)
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
from fewshotobjectdetection_imporove_via_text_feature_torch.engine.export import (
    FORMAT,
    ServingPredictor,
    export_inference,
    load_serving_artifact,
    save_serving_artifact,
)
from test_export_serving import TINY
from tests.test_full_network_oracle import _perturb
from tests.test_torch_model import match_detections


def tiny_cfg(extra=()):
    cfg = get_cfg()
    cfg.merge_from_list(list(TINY) + ["MODEL.WEIGHTS", ""] + list(extra))
    return cfg


def export_to(path, cfg, pred, batch=1):
    state = pred.model.state_dict()
    meta, programs = export_inference(cfg, state, batch=batch, device="cpu")
    save_serving_artifact(path, meta, programs, state)
    return meta, programs


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The port's tiny predictor on the JAX predictor's (perturbed) params,
    its artifact, and the JAX artifact of the same params."""
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(list(TINY))
    jpred = JaxPredictor(jcfg)
    jpred.params = _perturb(jax.device_get(jpred.params))
    cfg = tiny_cfg()
    pred = DefaultPredictor(cfg, device="cpu",
                            state_dict=state_dict_from_jax_params(jpred.params))
    d = tmp_path_factory.mktemp("srv")
    path = str(d / "tiny.fsodtf-torch")
    export_to(path, cfg, pred)
    jpath = str(d / "tiny.fsodtf")
    meta, programs = jax_export_inference(jcfg, jpred.params, batch=1)
    jax_save_serving_artifact(jpath, meta, programs, jpred.params)
    return cfg, pred, path, jpath


def _image(hw, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (*hw, 3), dtype=np.uint8)


def test_artifact_contents(artifact):
    _, pred, path, _ = artifact
    meta, state, programs = load_serving_artifact(path)
    # both orientations of the configured bucket, keyed (batch, h, w)
    assert set(programs) == {(1, 128, 192), (1, 192, 128)}
    assert meta["format"] == FORMAT and meta["batches"] == [1]
    assert meta["input_format"] == "BGR" and meta["device"] == "cpu"
    assert meta["min_size_test"] == 96 and meta["max_size_test"] == 192
    assert meta["compute_dtype"] == "float32" and "torch_version" in meta
    ref = pred.model.state_dict()
    assert set(state) == set(ref)
    assert all(np.array_equal(state[k].numpy(), ref[k].numpy()) for k in ref)
    # one copy of the weights: weights.pt; the programs carry no tensor of
    # the state dict and no example inputs
    n_weights = sum(v.numel() * v.element_size() for v in ref.values())
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        assert sorted(n for n in names if not n.startswith("programs/")) == [
            "meta.json", "weights.pt"]
        assert z.getinfo("weights.pt").file_size > n_weights
        for name in names:
            if not name.endswith(".pt2"):
                continue
            with zipfile.ZipFile(io.BytesIO(z.read(name))) as p:
                sizes = {i.filename: i.file_size for i in p.infolist()}
            tensors = sum(s for n, s in sizes.items()
                          if "/data/" in n and not n.endswith(".json"))
            assert tensors < 0.01 * n_weights, sizes


def test_programs_call_the_kernel_operators(artifact):
    """The counterpart of the JAX package's forced-NMS export cases: the
    programs trace the fsod:: operators (the hand-written kernels on the
    card, their plain versions here), never the plain NMS sweep."""
    _, _, path, _ = artifact
    _, _, programs = load_serving_artifact(path)
    for ep in programs.values():
        targets = [str(n.target) for n in ep.graph.nodes
                   if n.op == "call_function"]
        assert targets.count("fsod.nms_sorted.default") == 2
        assert targets.count("fsod.roi_align.default") == 1


@pytest.mark.parametrize("hw0", [(100, 150), (150, 100)])
def test_serving_matches_default_predictor_bitwise(artifact, hw0):
    _, pred, path, _ = artifact
    serving = ServingPredictor(path, device="cpu")
    img = _image(hw0, sum(hw0))
    a, b = pred(img), serving(img)
    assert len(a["boxes"]) > 5
    for k in ("boxes", "scores", "classes"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("hw0", [(100, 150), (150, 100)])
def test_serving_matches_jax_serving_predictor(artifact, hw0):
    _, _, path, jpath = artifact
    ours = ServingPredictor(path, device="cpu")(_image(hw0, sum(hw0)))
    ref = JaxServingPredictor(jpath)(_image(hw0, sum(hw0)))
    assert len(ref["boxes"]) > 5
    match_detections((ours["boxes"], ours["scores"], ours["classes"]),
                     (ref["boxes"], ref["scores"], ref["classes"]),
                     score_tol=1e-4)


def test_uncovered_bucket_rejected(artifact):
    _, _, path, _ = artifact
    serving = ServingPredictor(path, device="cpu")
    serving._programs = {
        k: v for k, v in serving._programs.items() if k == (1, 192, 128)
    }
    with pytest.raises(ValueError, match="re-export"):
        serving(np.zeros((100, 150, 3), np.uint8))  # needs (128, 192)


def test_device_and_format_are_checked(artifact, tmp_path):
    """An artifact serves on the device type it was traced for, and a zip
    that is not this package's artifact (the JAX package's) is refused."""
    _, _, path, jpath = artifact
    moved = str(tmp_path / "cuda.fsodtf-torch")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(moved, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                data = json.dumps(dict(json.loads(data), device="cuda"))
            dst.writestr(name, data)
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        ServingPredictor(moved, device="cpu")
    with pytest.raises(ValueError, match="not a serving artifact"):
        load_serving_artifact(jpath)


def test_batch_mismatch_rejected(artifact, tmp_path):
    cfg, pred, _, _ = artifact
    p = str(tmp_path / "b2.fsodtf-torch")
    export_to(p, cfg, pred, batch=2)
    with pytest.raises(ValueError, match="batch-1"):
        ServingPredictor(p, device="cpu")


def test_spatial_partition_rejected_by_export(artifact):
    cfg, pred, _, _ = artifact
    cfg2 = cfg.clone()
    cfg2.TPU.SPATIAL_PARTITION = 2
    with pytest.raises(ValueError, match="SPATIAL_PARTITION"):
        export_inference(cfg2, pred.model.state_dict(), device="cpu")
