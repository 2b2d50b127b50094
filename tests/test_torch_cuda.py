"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without an NVIDIA card every test here skips. NMS keep masks must be equal;
ROIAlign must agree within rtol/atol 1e-5 in float32 with TF32 off (the two
sum in different orders) and within 1e-2 in bfloat16 (both round an f32
sum once to bf16, so they may differ by one bf16 step).
"""

import numpy as np
import pytest
import torch

from fewshotobjectdetection_imporove_via_text_feature_torch.ops import (
    nms_auto,
    plain_ops,
    roi_align,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops.nms import (
    nms_sorted_plain,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops.nms_cuda import (
    nms_sorted_cuda,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align import (
    roi_align_plain,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align_cuda import (
    roi_align_cuda,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the kernels are CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _boxes(rng, b, n, size):
    xy = rng.uniform(0, size, (b, n, 2))
    wh = rng.uniform(1, size / 2, (b, n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    boxes[:, ::13, 2] = boxes[:, ::13, 0]  # zero width
    return boxes


@pytest.mark.parametrize("n,thresh,max_keep", [
    (100, 0.5, None), (3000, 0.7, 300), (6000, 0.7, 1000), (2048, 0.5, 100),
])
def test_nms_kernel_keep_mask_equals_plain(card, n, thresh, max_keep):
    rng = np.random.RandomState(n)
    boxes = torch.from_numpy(_boxes(rng, 3, n, 600)).to(card)
    valid = torch.from_numpy(rng.rand(3, n) > 0.05).to(card)
    before = nms_sorted_cuda.launches
    got = nms_sorted_cuda(boxes, valid, thresh, max_keep)
    assert nms_sorted_cuda.launches == before + 1
    assert torch.equal(got, nms_sorted_plain(boxes, valid, thresh, max_keep))


def test_dispatch_on_cuda_launches_the_kernel_unless_asked(card):
    rng = np.random.RandomState(1)
    boxes = torch.from_numpy(_boxes(rng, 1, 500, 300)[0]).to(card)
    scores = torch.rand(500, device=card)
    valid = torch.ones(500, dtype=torch.bool, device=card)
    before = nms_sorted_cuda.launches
    k1, _ = nms_auto(boxes, scores, valid, 0.5)
    assert nms_sorted_cuda.launches == before + 1
    with plain_ops():
        k2, _ = nms_auto(boxes, scores, valid, 0.5)
    assert nms_sorted_cuda.launches == before + 1
    assert torch.equal(k1, k2)


@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(rtol=1e-5, atol=1e-5)),
    (torch.bfloat16, dict(rtol=1e-2, atol=1e-2)),
])
@pytest.mark.parametrize("p,stride,sampling", [
    (7, 2, 0), (7, 1, 0), (7, 1, 2), (1, 1, 0),
])
def test_roi_align_kernel_matches_plain(card, dtype, tol, p, stride,
                                        sampling):
    rng = np.random.RandomState(p * 10 + stride)
    feat = torch.from_numpy(rng.randn(2, 64, 30, 44).astype(np.float32))
    feat = feat.to(card, dtype)
    boxes = torch.from_numpy(_boxes(rng, 2, 200, 500)).to(card)
    before = roi_align_cuda.launches
    got = roi_align(feat, boxes, p, 1 / 16.0, sampling, stride)
    assert roi_align_cuda.launches == before + 1
    ref = roi_align_plain(feat, boxes, p, 1 / 16.0, sampling, stride)
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), **tol)
