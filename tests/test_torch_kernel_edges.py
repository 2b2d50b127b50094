"""The port's plain NMS and ROIAlign against the JAX package's on the edge
cases of ``tests/test_torch_kernel_cases.py``, on the CPU.

NMS keep masks must be equal to the JAX ``nms_fixed`` bit for bit (the
plain version is what the CUDA kernel reproduces bit for bit on the card);
ROIAlign must agree with ``roi_align_mxu`` within rtol/atol 1e-5 in
float32 (the two sum in different orders).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fewshotobjectdetection_imporove_via_text_feature_tpu.ops import (
    nms_fixed as jax_nms,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.ops.roi_align_mxu import (
    roi_align_mxu,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops import (
    nms_fixed,
    roi_align,
    roi_align_plain,
)
from test_torch_kernel_cases import (
    NMS_CASES,
    ROI_CASES,
    nms_case,
    roi_case,
)

ROI_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", NMS_CASES)
def test_nms_edge_case_keep_equals_jax(name):
    boxes, valid, thr, mk = nms_case(name)
    b, n = valid.shape
    # score-sorted input, as both call sites hand it over
    scores = np.linspace(1.0, 0.0, n, dtype=np.float32)
    tk, _ = nms_fixed(_t(boxes), _t(np.tile(scores, (b, 1))), _t(valid),
                      thr, assume_sorted=True, max_keep=mk)
    for i in range(b):
        jk, _ = jax_nms(jnp.asarray(boxes[i]), jnp.asarray(scores),
                        jnp.asarray(valid[i]), thr, assume_sorted=True,
                        max_keep=mk)
        np.testing.assert_array_equal(tk[i].numpy(), np.asarray(jk),
                                      err_msg=f"image {i}")


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("name", ROI_CASES)
def test_roi_align_edge_case_matches_jax_mxu(name, layout):
    feat, boxes, p, scale, sampling, stride = roi_case(name)
    ft = _t(feat)
    if layout == "channels_last":
        ft = ft.contiguous(memory_format=torch.channels_last)
    got = roi_align_plain(ft, _t(boxes), p, scale, sampling, stride)
    p_out = len(range(0, p, stride))
    b, s = boxes.shape[:2]
    assert got.shape == (b, s, feat.shape[1], p_out, p_out)
    # the device switch sends CPU tensors to the plain version
    torch.testing.assert_close(
        roi_align(ft, _t(boxes), p, scale, sampling, stride), got,
        rtol=0, atol=0)
    for i in range(b):
        if s == 0:
            continue
        ref = np.asarray(roi_align_mxu(
            jnp.asarray(feat[i].transpose(1, 2, 0)), jnp.asarray(boxes[i]),
            p, scale, sampling, 128, stride))
        np.testing.assert_allclose(got[i].permute(0, 2, 3, 1).numpy(), ref,
                                   **ROI_TOL, err_msg=f"image {i}")
    if name == "outside":
        assert not got[:, :4].any()
