"""The PyTorch port's ops against the JAX package's, on the CPU.

Box ops, greedy NMS (keep masks exactly equal to JAX ``nms_fixed`` and to
the Pallas kernel run in interpret mode), and ROIAlignV2 (against
``roi_align_mxu`` and the gather ``roi_align``, rtol/atol 1e-5: the two
sum in different orders). Inputs are made with numpy from fixed seeds.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fewshotobjectdetection_imporove_via_text_feature_tpu.ops import (
    batched_nms_fixed as jax_batched_nms,
    box_ops as jbox,
    nms_fixed as jax_nms,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.ops.nms_pallas import (
    nms_fixed_pallas,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.ops.roi_align import (
    roi_align as jax_roi_align_gather,
    roi_sample_geometry as jax_geometry,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.ops.roi_align_mxu import (
    roi_align_mxu,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops import (
    batched_nms_fixed,
    box_ops,
    nms_auto,
    nms_fixed,
    plain_ops,
    roi_align,
    roi_align_plain,
    roi_sample_geometry,
    top_k,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops.nms import (
    nms_sorted_plain,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops.nms_cuda import (
    nms_sorted_cuda,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align_cuda import (
    roi_align_cuda,
)
from tests.test_box_ops import rand_boxes

ROI_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------ box ops
def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    a = rand_boxes(rng, 13)
    b = rand_boxes(rng, 29)
    b[3] = [10, 10, 10, 10]  # zero area
    np.testing.assert_array_equal(
        box_ops.pairwise_iou(_t(a), _t(b)).numpy(),
        np.asarray(jbox.pairwise_iou(jnp.asarray(a), jnp.asarray(b))),
    )
    np.testing.assert_array_equal(
        box_ops.box_area(_t(a)).numpy(), np.asarray(jbox.box_area(a)))
    deltas = rng.randn(13, 20).astype(np.float32) * 2
    deltas[0, 2] = 50.0  # beyond SCALE_CLAMP
    for w in [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)]:
        np.testing.assert_allclose(
            box_ops.decode_deltas(_t(deltas), _t(a), w).numpy(),
            np.asarray(jbox.decode_deltas(jnp.asarray(deltas),
                                          jnp.asarray(a), w)),
            rtol=1e-6, atol=1e-4,
        )
    big = a * 2 - 100
    np.testing.assert_array_equal(
        box_ops.clip_boxes(_t(big), (300.0, 500.0)).numpy(),
        np.asarray(jbox.clip_boxes(jnp.asarray(big), (300.0, 500.0))),
    )
    np.testing.assert_array_equal(
        box_ops.nonempty_mask(_t(b)).numpy(),
        np.asarray(jbox.nonempty_mask(jnp.asarray(b))),
    )


def test_top_k_breaks_ties_to_the_lower_index():
    import jax

    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]], np.float32)
    vals, idx = top_k(_t(x), 5)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 5)
    assert idx.tolist() == [[1, 3, 0, 2, 5]] == np.asarray(jidx).tolist()
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


# ------------------------------------------------------------ NMS
def _case(name):
    """(boxes, scores, valid, thresh, assume_sorted, max_keep) per case of
    tests/test_nms.py and tests/test_nms_pallas.py."""
    rng = np.random.RandomState(NMS_CASES.index(name))
    if name == "one_tile":
        n, size, thr = 100, 300, 0.5
    elif name == "many_tiles":
        n, size, thr = 300, 300, 0.7
    elif name == "padding":
        n, size, thr = 200, 300, 0.5
    elif name in ("multi_block_1400", "multi_block_2200"):
        n, size, thr = (1400, 300, 0.5) if name.endswith("1400") \
            else (2200, 300, 0.7)
    elif name == "dense":
        base = rand_boxes(rng, 40, size=100)
        boxes = (base[None] + rng.uniform(-8, 8, (8, 40, 4))).reshape(-1, 4)
        boxes = boxes.astype(np.float32)
        scores = rng.uniform(0, 1, len(boxes)).astype(np.float32)
        return boxes, scores, np.ones(len(boxes), bool), 0.5, False, None
    elif name == "sorted_ties":
        n = 300
        boxes = rand_boxes(rng, n, size=200)
        scores = np.sort(rng.uniform(0, 1, n).astype(np.float32))[::-1].copy()
        scores[50:60] = scores[50]
        valid = rng.rand(n) > 0.1
        return boxes, scores, valid, 0.5, True, None
    elif name == "chain":
        boxes = np.array([[0, 0, 10, 10], [5, 0, 15, 10],
                          [10.5, 0, 20.5, 10]], np.float32)
        scores = np.array([0.9, 0.8, 0.7], np.float32)
        return boxes, scores, np.ones(3, bool), 0.3, False, None
    elif name == "degenerate":
        boxes = rand_boxes(rng, 260, size=150)
        boxes[::7, 2] = boxes[::7, 0]  # zero width
        boxes[::11] = boxes[0]  # exact duplicates
        scores = rng.uniform(0, 1, 260).astype(np.float32)
        return boxes, scores, np.ones(260, bool), 0.5, False, None
    else:
        raise KeyError(name)
    boxes = rand_boxes(rng, n, size=size)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.uniform(0, 1, n) < (0.7 if name == "padding" else 0.8
                                    if name == "multi_block_2200" else 1.0)
    return boxes, scores, valid, thr, False, None


NMS_CASES = ["one_tile", "many_tiles", "padding", "multi_block_1400",
             "multi_block_2200", "dense", "sorted_ties", "chain",
             "degenerate"]


@pytest.mark.parametrize("name", NMS_CASES)
def test_nms_keep_equals_jax(name):
    boxes, scores, valid, thr, srt, mk = _case(name)
    jk, jo = jax_nms(jnp.asarray(boxes), jnp.asarray(scores),
                     jnp.asarray(valid), thr, assume_sorted=srt,
                     max_keep=mk)
    tk, to = nms_fixed(_t(boxes), _t(scores), _t(valid), thr,
                       assume_sorted=srt, max_keep=mk)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    ak, _ = nms_auto(_t(boxes), _t(scores), _t(valid), thr,
                     assume_sorted=srt, max_keep=mk)
    np.testing.assert_array_equal(ak.numpy(), np.asarray(jk))


@pytest.mark.parametrize("name", ["many_tiles", "dense", "sorted_ties",
                                  "degenerate"])
def test_nms_keep_equals_pallas_kernel_interpret(name):
    """The kernel's contract: the Pallas kernel's keep mask (interpret
    mode) equals the port's plain version bit for bit."""
    boxes, scores, valid, thr, srt, mk = _case(name)
    pk, _ = nms_fixed_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                             jnp.asarray(valid), thr, interpret=True,
                             assume_sorted=srt, max_keep=mk)
    tk, _ = nms_fixed(_t(boxes), _t(scores), _t(valid), thr,
                      assume_sorted=srt, max_keep=mk)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(pk))


def _sorted_budget_inputs():
    rng = np.random.RandomState(11)
    n = 2048
    boxes = rand_boxes(rng, n, size=400)
    scores = np.sort(rng.uniform(0, 1, n).astype(np.float32))[::-1].copy()
    valid = rng.rand(n) > 0.05
    return boxes, scores, valid


@pytest.mark.parametrize("max_keep", [1, 100, 128, 500, None])
def test_nms_max_keep_stops_at_the_same_tile(max_keep):
    boxes, scores, valid = _sorted_budget_inputs()
    jk, _ = jax_nms(jnp.asarray(boxes), jnp.asarray(scores),
                    jnp.asarray(valid), 0.5, assume_sorted=True,
                    max_keep=max_keep)
    tk, _ = nms_fixed(_t(boxes), _t(scores), _t(valid), 0.5,
                      assume_sorted=True, max_keep=max_keep)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_nms_max_keep_matches_pallas_kernel_interpret():
    boxes, scores, valid = _sorted_budget_inputs()
    pk, _ = nms_fixed_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                             jnp.asarray(valid), 0.5, interpret=True,
                             assume_sorted=True, max_keep=100)
    tk = nms_sorted_plain(_t(boxes)[None], _t(valid)[None], 0.5, 100)[0]
    np.testing.assert_array_equal(tk.numpy(), np.asarray(pk))


def test_nms_batched_rows_equal_per_image_jax():
    """One batched call (B, N) equals the JAX per-image results, with
    different stopping tiles per image under max_keep."""
    rng = np.random.RandomState(21)
    b, n = 3, 700
    boxes = np.stack([rand_boxes(rng, n, size=s) for s in (150, 300, 600)])
    scores = np.sort(rng.uniform(0, 1, (b, n)).astype(np.float32),
                     axis=1)[:, ::-1].copy()
    valid = rng.rand(b, n) > 0.1
    tk = nms_sorted_plain(_t(boxes), _t(valid), 0.7, 150).numpy()
    for i in range(b):
        jk, _ = jax_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                        jnp.asarray(valid[i]), 0.7, assume_sorted=True,
                        max_keep=150)
        np.testing.assert_array_equal(tk[i], np.asarray(jk))


def test_batched_nms_class_offsets_equal_jax():
    rng = np.random.RandomState(4)
    n = 600
    boxes = rand_boxes(rng, n, size=300)
    scores = np.sort(rng.uniform(0, 1, n).astype(np.float32))[::-1].copy()
    classes = rng.randint(0, 15, n).astype(np.int32)
    valid = rng.rand(n) > 0.2
    boxes[~valid] += 5000.0  # invalid boxes must not move the offset
    jk, _ = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                            jnp.asarray(classes), jnp.asarray(valid), 0.5,
                            assume_sorted=True, max_keep=100)
    tk, _ = batched_nms_fixed(_t(boxes), _t(scores), _t(classes), _t(valid),
                              0.5, assume_sorted=True, max_keep=100)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_kernel_wrappers_refuse_cpu_tensors():
    """No quiet fallback: the CUDA wrappers take CUDA tensors only, and the
    device switch sends CPU tensors to the plain versions."""
    boxes = torch.zeros(1, 4, 4)
    valid = torch.ones(1, 4, dtype=torch.bool)
    with pytest.raises(ValueError):
        nms_sorted_cuda(boxes, valid, 0.5)
    with pytest.raises(ValueError):
        roi_align_cuda(torch.zeros(1, 2, 4, 4), boxes)
    before = (nms_sorted_cuda.launches, roi_align_cuda.launches)
    with plain_ops():
        nms_auto(boxes[0], torch.ones(4), valid[0], 0.5)
    roi_align(torch.zeros(1, 2, 4, 4), boxes)
    assert (nms_sorted_cuda.launches, roi_align_cuda.launches) == before


# ------------------------------------------------------------ ROIAlign
def _roi_boxes():
    return np.array(
        [
            [0.0, 0.0, 160.0, 160.0],
            [35.0, 20.0, 300.0, 200.0],
            [100.0, 100.0, 140.0, 130.0],
            [-10.0, -10.0, 480.0, 330.0],
            [400.0, 200.0, 470.0, 310.0],
            [64.0, 64.0, 64.0, 200.0],  # degenerate width
            [5.0, 7.0, 9.0, 8.0],  # below one bin
        ],
        np.float32,
    )


def _port_roi(feat_hwc, boxes, p, scale, sampling, stride=1):
    out = roi_align_plain(_t(feat_hwc.transpose(2, 0, 1))[None],
                          _t(boxes)[None], p, scale, sampling, stride)
    return out[0].permute(0, 2, 3, 1).numpy()  # (R, P', P', C)


@pytest.mark.parametrize("hw", [(20, 30), (30, 20)])
@pytest.mark.parametrize("sampling", [2, 0])
@pytest.mark.parametrize("stride", [1, 2])
def test_roi_align_matches_jax_mxu_and_gather(hw, sampling, stride):
    rng = np.random.RandomState(5)
    feat = rng.randn(*hw, 8).astype(np.float32)
    boxes = _roi_boxes()
    mxu = np.asarray(roi_align_mxu(jnp.asarray(feat), jnp.asarray(boxes), 7,
                                   1 / 16.0, sampling, 0, stride))
    gather = np.asarray(jax_roi_align_gather(
        jnp.asarray(feat), jnp.asarray(boxes), 7, 1 / 16.0, sampling,
        stride))
    got = _port_roi(feat, boxes, 7, 1 / 16.0, sampling, stride)
    np.testing.assert_allclose(got, mxu, **ROI_TOL)
    np.testing.assert_allclose(got, gather, **ROI_TOL)
    if sampling == 0:
        assert np.all(got[5] == 0.0)  # g = 0 along x: zero output


@pytest.mark.parametrize("sampling", [2, 0])
def test_roi_align_1x1_pcb_mode_matches_jax(sampling):
    rng = np.random.RandomState(1)
    feat = rng.randn(10, 12, 4).astype(np.float32)
    boxes = np.array([[32.0, 32.0, 256.0, 192.0], [0.0, 0.0, 384.0, 320.0]],
                     np.float32)
    ref = np.asarray(roi_align_mxu(jnp.asarray(feat), jnp.asarray(boxes), 1,
                                   1 / 32.0, sampling))
    np.testing.assert_allclose(
        _port_roi(feat, boxes, 1, 1 / 32.0, sampling), ref, **ROI_TOL)


def test_roi_align_batched():
    """Per-image boxes over a (B, C, H, W) batch equal the JAX op image by
    image."""
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 16, 18, 6).astype(np.float32)
    boxes = np.stack([np.tile(_roi_boxes(), (5, 1))[:33] * 0.5,
                      np.tile(_roi_boxes(), (5, 1))[2:35] * 0.6])
    ft = _t(feats.transpose(0, 3, 1, 2))
    whole = roi_align(ft, _t(boxes), 7, 1 / 16.0, 0, 2)
    for i in range(2):
        ref = np.asarray(roi_align_mxu(jnp.asarray(feats[i]),
                                       jnp.asarray(boxes[i]), 7, 1 / 16.0, 0,
                                       0, 2))
        np.testing.assert_allclose(
            whole[i].permute(0, 2, 3, 1).numpy(), ref, **ROI_TOL)


@pytest.mark.parametrize("sampling", [2, 0])
def test_roi_sample_geometry_equals_jax(sampling):
    boxes = _roi_boxes()
    j = jax_geometry(jnp.asarray(boxes), 1 / 16.0, 7, sampling, 2,
                     jnp.float32, feat_hw=(20, 30))
    t = roi_sample_geometry(_t(boxes), 1 / 16.0, 7, sampling, 2,
                            feat_hw=(20, 30))
    assert (t.p_out, t.sy, t.sx) == (j.p_out, j.sy, j.sx)
    for name in ("y1", "x1", "bin_h", "bin_w", "grid_y", "grid_x", "wy",
                 "wx"):
        np.testing.assert_array_equal(
            getattr(t, name).numpy(), np.asarray(getattr(j, name)),
            err_msg=name)


def test_roi_align_bf16_reads_bf16_accumulates_f32():
    rng = np.random.RandomState(8)
    feat = torch.from_numpy(rng.randn(1, 8, 12, 16).astype(np.float32))
    boxes = _t(_roi_boxes()[None] * 0.4)
    ref = roi_align_plain(feat.to(torch.bfloat16).float(), boxes, 7,
                          1 / 16.0, 0, 2)
    got = roi_align_plain(feat.to(torch.bfloat16), boxes, 7, 1 / 16.0, 0, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref.to(torch.bfloat16).float().numpy())
