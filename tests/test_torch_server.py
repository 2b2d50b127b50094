"""The port's HTTP detection service (``engine/server.py``) over the port's
predictors on the CPU, a case for each case of tests/test_server.py: the
responses equal the wrapped predictor's, contract errors come back as HTTP
codes, dynamic batching coalesces requests; and the slice as a whole: an
exported artifact served over HTTP answers what the JAX package's
``ServingPredictor`` answers for the same weights and image."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

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
from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    DefaultPredictor,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine.export import (
    ServingPredictor,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.engine.server import (
    DetectionServer,
)
from test_export_serving import TINY
from test_server import assert_detections_setmatch
from test_torch_export_serving import export_to, tiny_cfg
from tests.test_full_network_oracle import _perturb
from tests.test_torch_model import match_detections


@pytest.fixture(scope="module")
def served():
    pred = DefaultPredictor(tiny_cfg(), device="cpu")
    server = DetectionServer(
        pred, port=0, class_names=[f"c{i}" for i in range(5)],
        meta={"num_classes": 5},
    ).start()
    yield pred, server
    server.stop()


def _url(server, path):
    return f"http://{server.host}:{server.port}{path}"


def _post(server, body, path="/detect"):
    req = urllib.request.Request(_url(server, path), data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _png(arr_rgb):
    buf = io.BytesIO()
    Image.fromarray(arr_rgb).save(buf, format="PNG")
    return buf.getvalue()


def _rgb(seed, hw=(100, 150)):
    return np.random.RandomState(seed).randint(0, 256, (*hw, 3),
                                               dtype=np.uint8)


def _assert_equal_detections(out, ref):
    np.testing.assert_allclose(out["boxes"], ref["boxes"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["scores"], ref["scores"], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(out["classes"], ref["classes"])


def _concurrently(fn, n):
    threads = [threading.Thread(target=fn, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)


def test_detect_matches_predictor(served):
    pred, server = served
    rgb = _rgb(0)
    out = _post(server, _png(rgb))
    # PNG is lossless: the server decodes what the predictor sees (BGR)
    ref = pred(rgb[:, :, ::-1])
    assert len(ref["boxes"]) > 5
    _assert_equal_detections(out, ref)
    assert out["class_names"] == [f"c{c}" for c in ref["classes"]]


def test_health_meta_and_counter(served):
    _, server = served
    _post(server, _png(_rgb(1)))
    with urllib.request.urlopen(_url(server, "/healthz")) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok" and h["requests_served"] >= 1
    with urllib.request.urlopen(_url(server, "/meta")) as r:
        m = json.loads(r.read())
    assert m["num_classes"] == 5 and m["class_names"][0] == "c0"
    assert m["max_batch"] == 1


def test_bad_payload_is_400(served):
    _, server = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, b"this is not an image")
    assert e.value.code == 400
    assert "decode" in json.loads(e.value.read())["error"]


def test_exif_orientation_applied(served):
    pred, server = served
    displayed = _rgb(2)
    # stored rotated with Orientation 6 ("rotate 90 CW to display")
    stored = np.rot90(displayed, k=1)
    exif = Image.Exif()
    exif[0x0112] = 6
    buf = io.BytesIO()
    Image.fromarray(stored).save(buf, format="PNG", exif=exif)
    out = _post(server, buf.getvalue())
    _assert_equal_detections(out, pred(displayed[:, :, ::-1]))


def test_internal_error_is_500(served):
    _, server = served
    real = server._predictor

    def boom(_):
        raise RuntimeError("device exploded")

    server._predictor = boom
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, _png(np.zeros((60, 80, 3), np.uint8)))
        assert e.value.code == 500
        assert "device exploded" in json.loads(e.value.read())["error"]
    finally:
        server._predictor = real


def test_oversized_body_is_413():
    server = DetectionServer(lambda im: {}, port=0,
                             max_body_bytes=1000).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, b"x" * 2000)
        assert e.value.code == 413
        assert "limit" in json.loads(e.value.read())["error"]
    finally:
        server.stop()


def test_unknown_route_is_404(served):
    _, server = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, b"x", path="/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(server, "/nope"))
    assert e.value.code == 404


def test_predict_batch_matches_single(served):
    pred, _ = served
    rng = np.random.RandomState(4)
    imgs = [rng.randint(0, 256, hw + (3,), dtype=np.uint8)
            for hw in [(100, 150), (150, 100), (90, 140), (100, 150),
                       (150, 100)]]
    for im, out in zip(imgs, pred.predict_batch(imgs)):
        assert_detections_setmatch(out, pred(im))


def test_dynamic_batching_groups_requests(served):
    """max_batch > 1: concurrent requests coalesce into predict_batch
    calls (fewer calls than requests) and every caller gets its own
    result."""
    pred, _ = served
    calls = []

    class Spy:
        def predict_batch(self, images):
            calls.append(len(images))
            return pred.predict_batch(images)

    server = DetectionServer(Spy(), port=0, max_batch=4,
                             batch_window_ms=1000.0).start()
    try:
        imgs = [_rgb(5 + k) for k in range(4)]
        outs = [None] * 4
        errs = []

        def post(k):
            try:
                outs[k] = _post(server, _png(imgs[k]))
            except Exception as e:  # surfaced below
                errs.append(e)

        _concurrently(post, 4)
        assert not errs
        assert sum(calls) == 4
        assert len(calls) < 4 and max(calls) >= 2  # coalesced
        for k in range(4):
            assert_detections_setmatch(outs[k], pred(imgs[k][:, :, ::-1]))
        with urllib.request.urlopen(_url(server, "/healthz")) as r:
            assert json.loads(r.read())["requests_served"] == 4
    finally:
        server.stop()


def test_batched_error_propagates_to_all_waiters():
    class Boom:
        def predict_batch(self, images):
            raise RuntimeError("batch exploded")

    server = DetectionServer(Boom(), port=0, max_batch=2,
                             batch_window_ms=500.0).start()
    try:
        codes = []

        def post(_):
            try:
                _post(server, _png(np.zeros((60, 80, 3), np.uint8)))
            except urllib.error.HTTPError as e:
                codes.append(e.code)

        _concurrently(post, 2)
        assert codes == [500, 500]
    finally:
        server.stop()


def test_max_batch_needs_predict_batch():
    with pytest.raises(ValueError, match="predict_batch"):
        DetectionServer(lambda im: {}, port=0, max_batch=4)


def test_artifact_backed_server_answers_the_jax_serving_predictor(tmp_path):
    """The slice as a whole: the JAX package's tiny predictor's params go
    into the port, the port exports an artifact (batches 1 and 4), a
    server with dynamic batching serves it over HTTP, and each answer
    matches the JAX package's ServingPredictor on the same weights and
    image (boxes IoU >= 0.99, scores within 1e-4, classes equal). A bucket
    the artifact lacks is HTTP 422."""
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(list(TINY))
    jpred = JaxPredictor(jcfg)
    jpred.params = _perturb(jax.device_get(jpred.params))
    meta, programs = jax_export_inference(jcfg, jpred.params, batch=1)
    jpath = str(tmp_path / "tiny.fsodtf")
    jax_save_serving_artifact(jpath, meta, programs, jpred.params)
    jserving = JaxServingPredictor(jpath)

    cfg = tiny_cfg()
    pred = DefaultPredictor(cfg, device="cpu",
                            state_dict=state_dict_from_jax_params(jpred.params))
    path = str(tmp_path / "tiny.fsodtf-torch")
    export_to(path, cfg, pred, batch=(1, 4))
    serving = ServingPredictor(path, device="cpu")
    server = DetectionServer(serving, port=0, max_batch=4,
                             batch_window_ms=200.0).start()
    try:
        rgbs = [_rgb(20 + k, hw) for k, hw in
                enumerate([(100, 150), (150, 100), (90, 140)])]
        outs = [None] * len(rgbs)

        def post(k):
            outs[k] = _post(server, _png(rgbs[k]))

        _concurrently(post, len(rgbs))
        for rgb, out in zip(rgbs, outs):
            ref = jserving(rgb[:, :, ::-1])
            assert len(ref["boxes"]) > 5
            match_detections(
                tuple(np.asarray(out[k], dtype)
                      for k, dtype in (("boxes", np.float32),
                                       ("scores", np.float32),
                                       ("classes", np.int64))),
                (ref["boxes"], ref["scores"], ref["classes"]))
        serving._programs = {
            k: v for k, v in serving._programs.items() if k[1:] == (192, 128)
        }
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, _png(rgbs[0]))
        assert e.value.code == 422
        assert "re-export" in json.loads(e.value.read())["error"]
    finally:
        server.stop()
