"""The hand-written kernels as PyTorch operators (``ops/custom_ops.py``),
on the CPU: ``torch.library.opcheck`` of ``fsod::nms_sorted``,
``fsod::roi_align`` and ``fsod::roi_align_backward`` (schema, fake
tensors, autograd registration, AOT dispatch), each operator bitwise equal
to its plain version, the forward's gradient equal to the plain
backward's, and the ops' device switches routing CPU tensors through the
operators. The CUDA cases are in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from fewshotobjectdetection_imporove_via_text_feature_torch.ops import (
    custom_ops,
    nms_auto,
    roi_align,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops.nms import (
    nms_sorted_plain,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.ops.roi_align import (
    roi_align_backward_plain,
    roi_align_plain,
)

ROI_ARGS = [(7, 1 / 16, 0, 1), (7, 1 / 16, 0, 2), (4, 0.25, 2, 1)]


def _boxes(b, n, scale, seed):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(b, n, 2, generator=g) * scale
    wh = torch.rand(b, n, 2, generator=g) * scale / 3
    return torch.cat([xy, xy + wh], dim=-1)


def _nms_inputs(seed=0):
    boxes = _boxes(2, 300, 100.0, seed)
    valid = torch.rand(2, 300, generator=torch.Generator().manual_seed(
        seed + 1)) > 0.1
    return boxes, valid


@pytest.mark.parametrize("thresh,max_keep", [(0.5, 100), (0.7, -1),
                                             (0.3, 5)])
def test_nms_operator_passes_opcheck_and_equals_plain(thresh, max_keep):
    boxes, valid = _nms_inputs()
    torch.library.opcheck(torch.ops.fsod.nms_sorted,
                          (boxes, valid, thresh, max_keep))
    keep = torch.ops.fsod.nms_sorted(boxes, valid, thresh, max_keep)
    want = nms_sorted_plain(boxes, valid, thresh,
                            None if max_keep < 0 else max_keep)
    assert keep.dtype == torch.bool and keep.is_contiguous()
    assert torch.equal(keep, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("args", ROI_ARGS)
def test_roi_align_operators_pass_opcheck_and_equal_plain(dtype, args):
    g = torch.Generator().manual_seed(3)
    feats = torch.randn(2, 8, 12, 16, generator=g, dtype=dtype)
    feats.requires_grad_(True)
    boxes = _boxes(2, 5, 150.0, 4)
    torch.library.opcheck(torch.ops.fsod.roi_align, (feats, boxes, *args))
    out = torch.ops.fsod.roi_align(feats, boxes, *args)
    ref = roi_align_plain(feats, boxes, *args)
    assert torch.equal(out, ref)
    grad = torch.randn(out.shape, generator=g, dtype=dtype)
    torch.library.opcheck(torch.ops.fsod.roi_align_backward,
                          (grad, boxes, list(feats.shape), *args))
    back = torch.ops.fsod.roi_align_backward(grad, boxes, list(feats.shape),
                                             *args)
    assert torch.equal(back, roi_align_backward_plain(
        grad, boxes, feats.shape, *args))
    # the operator's autograd is its backward operator; the plain
    # version's autograd sums in its own order
    (g_op,) = torch.autograd.grad(out, feats, grad)
    (g_plain,) = torch.autograd.grad(ref, feats, grad)
    assert torch.equal(g_op, back)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(g_op, g_plain, rtol=0,
                               atol=tol * float(g_plain.abs().max()))


def test_roi_align_operator_with_no_roi():
    feats = torch.randn(1, 4, 6, 6, requires_grad=True)
    boxes = torch.zeros(1, 0, 4)
    out = torch.ops.fsod.roi_align(feats, boxes, 7, 1.0, 0, 1)
    assert out.shape == (1, 0, 4, 7, 7)
    (g,) = torch.autograd.grad(out.sum(), feats)
    assert not g.any()


def test_the_device_switches_route_cpu_tensors_through_the_operators(
        monkeypatch):
    calls = []
    for name in ("nms_sorted", "roi_align"):
        op = getattr(torch.ops.fsod, name)

        def spy(*a, _op=op, _name=name):
            calls.append(_name)
            return _op(*a)

        monkeypatch.setattr(torch.ops.fsod, name, spy)
    boxes, valid = _nms_inputs(2)
    scores = torch.rand(valid.shape, generator=torch.Generator().manual_seed(5))
    keep, order = nms_auto(boxes, scores, valid, 0.5)
    feats = torch.randn(2, 8, 12, 16)
    pooled = roi_align(feats, _boxes(2, 5, 150.0, 4), 7, 1 / 16, 0, 2)
    assert calls == ["nms_sorted", "roi_align"]
    assert pooled.shape == (2, 5, 8, 4, 4)
    assert keep.shape == order.shape == valid.shape


def test_the_module_registers_the_three_operators():
    assert {"nms_sorted", "roi_align", "roi_align_backward"} <= {
        name for name in dir(torch.ops.fsod)}
    assert custom_ops.nms_sorted is not None
    # the scalars are schema arguments (int reads as SymInt)
    schema = str(torch.ops.fsod.roi_align.default._schema)
    assert "Int output_size, float spatial_scale, SymInt sampling_ratio, " \
        "SymInt bin_stride" in schema
    np.testing.assert_array_equal(
        torch.ops.fsod.nms_sorted(torch.zeros(1, 0, 4),
                                  torch.zeros(1, 0, dtype=torch.bool),
                                  0.5, -1).shape, (1, 0))
