"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Without an NVIDIA card every test here skips. NMS keep masks must be equal;
ROIAlign must agree within rtol/atol 1e-5 in float32 with TF32 off (the two
sum in different orders) and within 1e-2 in bfloat16 (both round an f32
sum once to bf16, so they may differ by one bf16 step). The ROIAlign
backward kernel must agree with the autograd of the plain version within
1e-5 of the gradient's largest value in float32 (the two sum in different
orders) and within one bf16 step (2^-7 relative) more in bfloat16, and two
of its launches on the same inputs must be bitwise equal; a train
step of a tiny detector through the kernels, flagship and text head (the
teacher's cross-ROI attention and the distilled student), must agree with
the same step through the plain versions (losses rtol 1e-4, gradients 1e-4
of each tensor's largest value); a text serving batch through the kernels
must match it through the plain versions as the evaluation path does; the
evaluation path (page-locked test batches ->
inference_on_dataset) through the kernels must match it through the plain
versions (95% of each image's detections matched: class, IoU >= 0.9, score
within 1e-3; AP50 within 0.5 points). Two gloo ranks sharing the card:
``all_gather_with_grad`` gathers and sends the gradient back exactly, and
a data-parallel step of the tiny detector through the kernels equals one
process's step on the global batch (losses rtol 1e-5, gradients 1e-4 of
each tensor's largest value).
"""

import os

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
    roi_align_bwd_cuda,
    roi_align_cuda,
)
from test_torch_kernel_cases import (
    NMS_CASES,
    ROI_CASES,
    nms_case,
    roi_case,
    roi_grad_out,
)

ROI_TOLS = [
    (torch.float32, dict(rtol=1e-5, atol=1e-5)),
    (torch.bfloat16, dict(rtol=1e-2, atol=1e-2)),
]

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


@pytest.mark.parametrize("name", NMS_CASES)
def test_nms_kernel_edge_cases_equal_plain(card, name):
    boxes, valid, thresh, max_keep = nms_case(name)
    boxes = torch.from_numpy(boxes).to(card)
    valid = torch.from_numpy(valid).to(card)
    got = nms_sorted_cuda(boxes, valid, thresh, max_keep)
    assert torch.equal(got, nms_sorted_plain(boxes, valid, thresh, max_keep))


@pytest.mark.parametrize("dtype,tol", ROI_TOLS)
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


def test_roi_align_kernel_matches_plain_at_the_pcb_shape(card):
    """PCB's call: float32 res5 maps of 2048 channels at 1/32 for a group of
    images padded to 512x384 (NCHW, as the network returns them), whole
    boxes in original coordinates, P 1, adaptive sampling."""
    rng = np.random.RandomState(11)
    feat = torch.from_numpy(
        rng.randn(4, 2048, 384 // 32, 512 // 32).astype(np.float32)).to(card)
    xy = rng.uniform(0, 450, (4, 20, 2))
    wh = rng.uniform(4, 300, (4, 20, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [500, 375])], axis=-1)
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(card)
    before = roi_align_cuda.launches
    got = roi_align(feat, boxes, 1, 1 / 32.0, 0)
    assert roi_align_cuda.launches == before + 1
    ref = roi_align_plain(feat, boxes, 1, 1 / 32.0, 0)
    assert got.shape == ref.shape == (4, 20, 2048, 1, 1)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", ROI_TOLS)
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("name", ROI_CASES)
def test_roi_align_kernel_edge_cases_match_plain(card, dtype, tol, layout,
                                                 name):
    feat, boxes, p, scale, sampling, stride = roi_case(name)
    feat = torch.from_numpy(feat).to(card, dtype)
    if layout == "channels_last":
        feat = feat.contiguous(memory_format=torch.channels_last)
    boxes = torch.from_numpy(boxes).to(card)
    got = roi_align_cuda(feat, boxes, p, scale, sampling, stride)
    ref = roi_align_plain(feat, boxes, p, scale, sampling, stride)
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    if name == "outside":
        assert not got[:, :4].any()


@pytest.mark.parametrize("dtype,tol", ROI_TOLS)
def test_roi_align_kernel_reads_an_unaligned_base(card, dtype, tol):
    """Channels-last features whose storage starts one element past a
    16-byte boundary take the channel-by-channel loop."""
    feat, boxes, p, scale, sampling, stride = roi_case("c1024")
    b, c, h, w = feat.shape
    flat = torch.empty(1 + feat.size, dtype=dtype, device=card)
    nhwc = flat[1:].view(b, h, w, c)
    nhwc.copy_(torch.from_numpy(feat).permute(0, 2, 3, 1))
    feat = nhwc.permute(0, 3, 1, 2)
    assert feat.data_ptr() % 16 and feat.is_contiguous(
        memory_format=torch.channels_last)
    boxes = torch.from_numpy(boxes).to(card)
    got = roi_align_cuda(feat, boxes, p, scale, sampling, stride)
    ref = roi_align_plain(feat, boxes, p, scale, sampling, stride)
    torch.testing.assert_close(got.float(), ref.float(), **tol)


def test_roi_align_kernel_reads_past_2_31_elements_of_one_image(card):
    """One bf16 image of 16400 x 16400 x 8 (2^31 + 4.4 M elements): ROIs
    in its last rows read elements past the reach of a 32-bit offset."""
    h = w = 16400
    c = 8
    assert h * w * c > 2 ** 31
    gen = torch.Generator(device=card).manual_seed(5)
    nhwc = torch.randn((1, h, w, c), generator=gen, device=card,
                       dtype=torch.bfloat16)
    feat = nhwc.permute(0, 3, 1, 2)  # channels-last view
    boxes = torch.tensor([[[100.0, 16372.0, 160.0, 16396.0],
                           [15000.0, 16370.0, 16390.0, 16399.0],
                           [10.0, 10.0, 50.0, 40.0]]], device=card)
    got = roi_align_cuda(feat, boxes, 7, 1.0, 2, 1)
    ref = roi_align_plain(feat, boxes, 7, 1.0, 2, 1)
    torch.testing.assert_close(got.float(), ref.float(), **ROI_TOLS[1][1])
    assert got[:, :2].abs().sum() > 0


def _plain_grad(feat, boxes, p, scale, sampling, stride, grad_out):
    f = feat.detach().clone().requires_grad_(True)
    roi_align_plain(f, boxes, p, scale, sampling, stride).backward(grad_out)
    return f.grad


def _assert_grad_close(got, ref):
    """float32: within 1e-5 of ref's largest value; bfloat16: within one
    bf16 step (2^-7 relative) more."""
    ref32 = ref.float()
    atol = 1e-5 * float(ref32.abs().max())
    rtol = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got.float(), ref32, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ROI_CASES)
def test_roi_align_bwd_kernel_matches_plain_gradient(card, dtype, name):
    feat, boxes, p, scale, sampling, stride = roi_case(name)
    feat = torch.from_numpy(feat).to(card, dtype)
    boxes = torch.from_numpy(boxes).to(card)
    g = torch.from_numpy(roi_grad_out(name)).to(card, dtype)
    before = roi_align_bwd_cuda.launches
    got = roi_align_bwd_cuda(g, boxes, feat.shape, p, scale, sampling,
                             stride)
    # no ROI (s0) gives zeros with no launch
    assert roi_align_bwd_cuda.launches == before + (name != "s0")
    ref = _plain_grad(feat, boxes, p, scale, sampling, stride, g)
    assert got.dtype == dtype and got.shape == ref.shape
    _assert_grad_close(got, ref)
    if name == "s0":
        assert not got.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_bwd_kernel_two_launches_are_bitwise_equal(card, dtype):
    """Every pixel sums its (ROI, bin) terms in one fixed order, so the
    gradient does not change from launch to launch; on ``dense`` every tile
    gathers every ROI."""
    feat, boxes, p, scale, sampling, stride = roi_case("dense")
    boxes = torch.from_numpy(boxes).to(card)
    g = torch.from_numpy(roi_grad_out("dense")).to(card, dtype)
    first = roi_align_bwd_cuda(g, boxes, feat.shape, p, scale, sampling,
                               stride)
    second = roi_align_bwd_cuda(g, boxes, feat.shape, p, scale, sampling,
                                stride)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(first.view(bits), second.view(bits))
    assert first.abs().sum() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_bwd_kernel_reads_an_unaligned_grad(card, dtype):
    feat, boxes, p, scale, sampling, stride = roi_case("c1024")
    b, s = boxes.shape[:2]
    c = feat.shape[1]
    p_out = len(range(0, p, stride))
    g = torch.from_numpy(roi_grad_out("c1024")).to(card, dtype)
    flat = torch.empty(1 + g.numel(), dtype=dtype, device=card)
    nhwc = flat[1:].view(b, s, p_out, p_out, c)
    nhwc.copy_(g.permute(0, 1, 3, 4, 2))
    g_view = nhwc.permute(0, 1, 4, 2, 3)  # what the forward hands back
    assert g_view.data_ptr() % 16
    feat = torch.from_numpy(feat).to(card, dtype)
    boxes = torch.from_numpy(boxes).to(card)
    got = roi_align_bwd_cuda(g_view, boxes, feat.shape, p, scale, sampling,
                             stride)
    _assert_grad_close(got, _plain_grad(feat, boxes, p, scale, sampling,
                                        stride, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_on_cuda_gives_the_features_a_gradient(card, dtype):
    """On a CUDA tensor ``roi_align`` goes through the autograd Function:
    the features get the backward kernel's gradient (they once got none)."""
    rng = np.random.RandomState(3)
    feat = torch.from_numpy(rng.randn(2, 64, 30, 44).astype(np.float32))
    feat = feat.to(card, dtype).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    boxes = torch.from_numpy(_boxes(rng, 2, 100, 500)).to(card)
    g = torch.randn(2, 100, 64, 4, 4, device=card).to(dtype)
    fwd, bwd = roi_align_cuda.launches, roi_align_bwd_cuda.launches
    out = roi_align(feat, boxes, 7, 1 / 16.0, 0, 2)
    assert out.grad_fn is not None
    out.backward(g)
    assert roi_align_cuda.launches == fwd + 1
    assert roi_align_bwd_cuda.launches == bwd + 1
    assert feat.grad is not None and feat.grad.dtype == dtype
    _assert_grad_close(feat.grad, _plain_grad(feat, boxes, 7, 1 / 16.0, 0,
                                              2, g))


def _tiny_detector(card, **kw):
    """A tiny detector with live residual branches on the card, in training
    mode, and a batch of two images with four GT boxes each."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
        init_weights,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        GeneralizedRCNN,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
        GTInstances,
        ImageBatch,
    )

    model = GeneralizedRCNN(
        num_classes=5, depth=14, stem_out_channels=8,
        res2_out_channels=16, width_per_group=4, freeze_at=0,
        rpn_pre_nms_topk=(1200, 1200), rpn_post_nms_topk=(300, 300),
        rpn_batch_per_image=256, roi_batch_per_image=512, **kw,
    )
    gen = torch.Generator().manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():  # live residual branches
        for name, p in model.named_parameters():
            if name.endswith("conv3.weight"):
                p.normal_(0.0, 0.05, generator=gen)
    model = model.to(card).train()
    rng = np.random.RandomState(7)
    images = ImageBatch(
        image=torch.from_numpy(rng.uniform(0, 255, (2, 128, 160, 3))
                               .astype(np.float32)),
        hw=torch.tensor([[128, 160], [96, 128]], dtype=torch.int32),
        orig_hw=torch.tensor([[128, 160], [96, 128]], dtype=torch.int32),
    ).to(card)
    xy = rng.uniform(0, 80, (2, 8, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(16, 40, (2, 8, 2))], -1)
    gt = GTInstances(
        boxes=torch.from_numpy(boxes.astype(np.float32)),
        classes=torch.from_numpy(rng.randint(0, 5, (2, 8)).astype(
            np.int32)),
        valid=torch.from_numpy(np.arange(8)[None].repeat(2, 0) < 4),
    ).to(card)
    return model, images, gt


def _step_matches_plain_ops(card, model, images, gt, launches=(1, 2, 2)):
    """One training forward/backward through the kernels (launching NMS,
    the ROIAlign forward and its backward ``launches`` times: once, and
    twice each for the res5 head's two chunks) against the same step
    through the plain versions: losses rtol 1e-4, every gradient within
    1e-4 of its largest value. Returns the kernels' losses."""
    def step():
        model.zero_grad(set_to_none=True)
        losses = model.forward_train(
            images, gt, torch.Generator(device=card).manual_seed(1))
        sum(v for k, v in losses.items()
            if not k.startswith("metric/")).backward()
        return losses, {n: p.grad.clone()
                        for n, p in model.named_parameters()
                        if p.grad is not None}

    torch.backends.cudnn.deterministic = True
    try:
        counts = (nms_sorted_cuda.launches, roi_align_cuda.launches,
                  roi_align_bwd_cuda.launches)
        got, got_g = step()
        assert (nms_sorted_cuda.launches - counts[0],
                roi_align_cuda.launches - counts[1],
                roi_align_bwd_cuda.launches - counts[2]) == launches
        with plain_ops():
            ref, ref_g = step()
    finally:
        torch.backends.cudnn.deterministic = False
    for k in ref:
        torch.testing.assert_close(got[k].float(), ref[k].float(),
                                   rtol=1e-4, atol=1e-7, msg=k)
    assert float(got["loss_box_reg"].detach()) > 0
    for name, g in ref_g.items():
        torch.testing.assert_close(
            got_g[name], g, rtol=0,
            atol=1e-4 * float(g.abs().max()), msg=name)
    assert float(got_g["backbone.res4.0.conv1.weight"].abs().max()) > 0
    return got


def test_tiny_train_step_with_kernels_matches_plain_ops(card):
    _step_matches_plain_ops(card, *_tiny_detector(card))


def test_tiny_standard_roi_heads_step_with_kernels_matches_plain_ops(card):
    """StandardROIHeads pools at P 7, bin_stride 1, in one ROIAlign launch
    a step, forward and backward."""
    got = _step_matches_plain_ops(
        card, *_tiny_detector(card, roi_heads_name="StandardROIHeads",
                              box_convfc=(1, 32, 2, 64)),
        launches=(1, 1, 1))
    assert float(got["loss_cls"].detach()) > 0


def test_tiny_remat_step_with_kernels_matches_plain_ops(card):
    """TPU.REMAT_BACKBONE recomputes the stages in the backward pass; the
    kernels are launched as without it."""
    _step_matches_plain_ops(card, *_tiny_detector(card, remat_backbone=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_operators_on_cuda_launch_the_kernels(card, dtype):
    """``fsod::`` operators on CUDA tensors are the launchers: one launch
    each, the plain versions' results."""
    rng = np.random.RandomState(3)
    boxes = torch.from_numpy(_boxes(rng, 2, 3000, 600)).to(card)
    valid = torch.from_numpy(rng.rand(2, 3000) > 0.05).to(card)
    before = nms_sorted_cuda.launches
    keep = torch.ops.fsod.nms_sorted(boxes, valid, 0.7, 300)
    assert nms_sorted_cuda.launches == before + 1
    assert torch.equal(keep, nms_sorted_plain(boxes, valid, 0.7, 300))
    feat = torch.randn(2, 64, 30, 40, device=card).to(dtype)
    rois = torch.from_numpy(_boxes(rng, 2, 50, 600)).to(card)
    tol = dict(ROI_TOLS)[dtype]
    for stride in (1, 2):
        fwd, bwd = roi_align_cuda.launches, roi_align_bwd_cuda.launches
        out = torch.ops.fsod.roi_align(feat, rois, 7, 1 / 16.0, 0, stride)
        torch.testing.assert_close(
            out, roi_align_plain(feat, rois, 7, 1 / 16.0, 0, stride), **tol)
        g = torch.randn(out.shape, device=card).to(dtype)
        grad = torch.ops.fsod.roi_align_backward(
            g, rois, list(feat.shape), 7, 1 / 16.0, 0, stride)
        assert (roi_align_cuda.launches, roi_align_bwd_cuda.launches) == (
            fwd + 1, bwd + 1)
        assert grad.shape == feat.shape and grad.dtype == dtype
        _assert_grad_close(grad, _plain_grad(feat, rois, 7, 1 / 16.0, 0,
                                             stride, g))


def _tiny_serving_cfg():
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )

    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.WEIGHTS", "", "MODEL.RESNETS.DEPTH", "14",
        "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
        "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
        "MODEL.RESNETS.WIDTH_PER_GROUP", "4",
        "MODEL.RPN.PRE_NMS_TOPK_TEST", "128",
        "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
        "MODEL.ROI_HEADS.NUM_CLASSES", "5",
        "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
        "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "192",
        "TPU.IMAGE_BUCKETS", "[(128, 192)]",
        "TPU.COMPUTE_DTYPE", "float32",
    ])
    return cfg


def test_exported_program_on_cuda_launches_the_kernels(card, tmp_path):
    """A serving artifact exported on the card: each forward launches NMS
    twice and the ROIAlign forward once, as DefaultPredictor's does, and
    its detections set-match DefaultPredictor's."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        DefaultPredictor,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.export import (
        ServingPredictor,
        export_inference,
        save_serving_artifact,
    )

    cfg = _tiny_serving_cfg()
    pred = DefaultPredictor(cfg, device=card)
    state = pred.model.state_dict()
    meta, programs = export_inference(cfg, state, batch=(1, 2))
    assert meta["device"] == "cuda"
    path = str(tmp_path / "tiny.fsodtf-torch")
    save_serving_artifact(path, meta, programs, state)
    serving = ServingPredictor(path)
    img = np.random.RandomState(1).randint(0, 256, (100, 150, 3), np.uint8)
    launches = []
    for run in (pred, serving):
        counts = (nms_sorted_cuda.launches, roi_align_cuda.launches)
        out = run(img)
        launches.append((nms_sorted_cuda.launches - counts[0],
                         roi_align_cuda.launches - counts[1]))
        if run is pred:
            ref = out
    assert launches == [(2, 1), (2, 1)]
    assert len(ref["boxes"]) > 5
    _assert_set_match(out, ref)
    for a, b in zip(serving.predict_batch([img, img[::-1]]),
                    pred.predict_batch([img, img[::-1]])):
        _assert_set_match(a, b)


def _assert_set_match(out, ref, min_share=0.95):
    """At least ``min_share`` of ``ref``'s detections have one in ``out``
    with the class, IoU >= 0.9 and a score within 1e-3."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.ops import (
        pairwise_iou,
    )

    assert abs(len(out["boxes"]) - len(ref["boxes"])) <= 0.05 * len(
        ref["boxes"]) + 1
    iou = pairwise_iou(torch.from_numpy(ref["boxes"]),
                       torch.from_numpy(out["boxes"])).numpy()
    ok = ((iou >= 0.9)
          & (ref["classes"][:, None] == out["classes"][None, :])
          & (np.abs(ref["scores"][:, None] - out["scores"][None, :])
             <= 1e-3))
    assert ok.any(axis=1).mean() >= min_share


def test_device_resize_on_cuda_matches_the_cpu(card):
    from fewshotobjectdetection_imporove_via_text_feature_torch.data.device_preprocess import (
        device_resize_batch,
    )

    rng = np.random.RandomState(0)
    raw = torch.from_numpy(rng.randint(0, 256, (3, 384, 512, 3)).astype(
        np.uint8))
    hw = torch.tensor([[375, 500], [333, 500], [384, 300]], dtype=torch.int32)
    flip = torch.tensor([False, True, False])
    short = torch.tensor([480.0, 600.0, 800.0])
    want, want_hw = device_resize_batch(raw, hw, flip, short, 1333,
                                        (800, 1344))
    got, got_hw = device_resize_batch(raw.to(card), hw.to(card),
                                      flip.to(card), short.to(card), 1333,
                                      (800, 1344))
    assert torch.equal(got_hw.cpu(), want_hw)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)


def _text_head(**kw):
    rng = np.random.RandomState(0)
    bank = rng.randn(5, 16).astype(np.float32)
    return dict(roi_heads_name="TextRes5ROIHeads",
                class_embed=bank / np.linalg.norm(bank, axis=1,
                                                  keepdims=True),
                distill_l2=True, distill_kl=True, kl_temp=5.0, **kw)


def test_tiny_text_train_step_with_kernels_matches_plain_ops(card):
    """The text head of run_text_train_student.sh: the teacher's losses,
    the KL and feature distillation and the cross-ROI attention's
    gradients through the kernels match the plain ops."""
    got = _step_matches_plain_ops(card, *_tiny_detector(card,
                                                        **_text_head()))
    assert {"loss_cls_t", "loss_box_reg_t", "loss_kl",
            "loss_student_feat"} <= set(got)


def test_tiny_text_serving_batch_with_kernels_matches_plain_ops(card):
    """The text detector's inference through the kernels (NMS twice, the
    ROIAlign forward twice for 300 proposals in chunks of 256) against the
    plain ops: the student without GT, the teacher on GT-labelled
    proposals."""
    model, images, gt = _tiny_detector(card, **_text_head(
        test_score_thresh=0.0))
    model.eval()
    for g in (None, gt):
        with torch.inference_mode():
            counts = (nms_sorted_cuda.launches, roi_align_cuda.launches)
            det = model.forward_inference(images, g)
            assert (nms_sorted_cuda.launches - counts[0],
                    roi_align_cuda.launches - counts[1]) == (2, 2)
            with plain_ops():
                ref = model.forward_inference(images, g)
        for i in range(2):
            a, b = (tuple(t[i][d.valid[i]].cpu().numpy() for t in
                          (d.boxes, d.scores, d.classes))
                    for d in (det, ref))
            assert len(a[0]) > 10
            assert min(_matched_share(a, b), _matched_share(b, a)) >= 0.95


def _workflow_cfg(root):
    """A tiny detector over a synthetic VOC at ``root``, on the card."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )

    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.WEIGHTS", "", "MODEL.DEVICE", "cuda",
        "MODEL.RESNETS.DEPTH", "14", "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
        "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
        "MODEL.RESNETS.WIDTH_PER_GROUP", "4", "MODEL.BACKBONE.FREEZE_AT", "0",
        "MODEL.ROI_HEADS.NUM_CLASSES", "20",
        "MODEL.RPN.PRE_NMS_TOPK_TEST", "600",
        "MODEL.RPN.POST_NMS_TOPK_TEST", "300",
        "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
        "TPU.IMAGE_BUCKETS", "((192,256),)", "TPU.MAX_GT", "10",
        "TPU.MAX_DETECTIONS_PRE_NMS", "256", "TPU.COMPUTE_DTYPE", "float32",
        "INPUT.MIN_SIZE_TEST", "192", "INPUT.MAX_SIZE_TEST", "256",
        "DATALOADER.NUM_WORKERS", "2",
    ])
    return cfg


def _matched_share(a, b, iou_min=0.9, score_tol=1e-3):
    """Share of ``a``'s detections (boxes, scores, classes) with one in
    ``b`` of the same class, IoU >= iou_min and a score within
    score_tol."""
    if not len(a[0]):
        return 1.0 if not len(b[0]) else 0.0
    x, y = a[0].astype(np.float64), b[0].astype(np.float64)
    lt = np.maximum(x[:, None, :2], y[None, :, :2])
    rb = np.minimum(x[:, None, 2:], y[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda t: (t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1])  # noqa
    union = area(x)[:, None] + area(y)[None, :] - inter
    iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0)
    ok = ((iou >= iou_min) & (a[2][:, None] == b[2][None, :])
          & (np.abs(a[1][:, None] - b[1][None, :]) <= score_tol))
    return float(ok.any(axis=1).mean())


def test_test_loader_and_inference_on_dataset_match_plain_ops(card, tmp_path):
    """The evaluation path on the card: page-locked test batches (padded
    tail) -> inference_on_dataset through the kernels, against the same
    run through the plain versions; float32, TF32 off, deterministic
    convolutions. Per image, at least 95% of each run's detections match
    (same class, IoU >= 0.9, score within 1e-3) and AP50 is within 0.5
    points."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
        init_weights,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
        build_detection_test_loader,
        register_all,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation import (
        DatasetEvaluator,
        PascalVOCDetectionEvaluator,
        inference_on_dataset,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        build_model,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_voc import (
        make_voc,
    )

    class Recorder(DatasetEvaluator):
        def reset(self):
            self.batches = []

        def process_detections(self, *args):
            self.batches.append(args)

        def evaluate(self):
            return {}

    make_voc(str(tmp_path), images=6)
    register_all(str(tmp_path))
    cfg = _workflow_cfg(str(tmp_path))
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():  # live residual branches
        for name, p in model.named_parameters():
            if name.endswith("conv3.weight"):
                p.normal_(0.0, 0.05, generator=gen)
    model = model.to(card)
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for name in ("kernels", "plain"):
            rec = Recorder()
            counts = (nms_sorted_cuda.launches, roi_align_cuda.launches)
            loader = build_detection_test_loader(
                cfg, "voc_2007_test_all1", batch_size=4, pin_memory=True)
            if name == "plain":
                with plain_ops():
                    inference_on_dataset(model, loader, rec)
            else:
                inference_on_dataset(model, loader, rec)
            runs[name] = (rec.batches, nms_sorted_cuda.launches - counts[0],
                          roi_align_cuda.launches - counts[1])
    finally:
        torch.backends.cudnn.deterministic = False
    (got, nms_n, roi_n), (ref, plain_nms, plain_roi) = runs["kernels"], \
        runs["plain"]
    assert (nms_n, roi_n) == (2 * 2, 2 * 2)  # 2 batches: RPN + final; 2 chunks
    assert (plain_nms, plain_roi) == (0, 0)
    assert [len(b[0]) for b in got] == [4, 2]  # the padded tail is dropped
    total = 0
    for a, b in zip(got, ref):
        assert list(a[0]) == list(b[0])
        for i in range(len(a[0])):
            da = tuple(x[i][a[4][i]] for x in a[1:4])
            db = tuple(x[i][b[4][i]] for x in b[1:4])
            total += len(da[0])
            assert min(_matched_share(da, db), _matched_share(db, da)) >= 0.95
    assert total > 20
    ap = []
    for batches in (got, ref):
        ev = PascalVOCDetectionEvaluator("voc_2007_test_all1")
        ev.reset()
        for b in batches:
            ev.process_detections(*b)
        ap.append(ev.evaluate()["bbox"]["AP50"])
    assert abs(ap[0] - ap[1]) <= 0.5


def test_pinned_batches_reach_the_card_unchanged(card, tmp_path):
    from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
        build_detection_test_loader,
        device_batches,
        register_all,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_voc import (
        make_voc,
    )

    make_voc(str(tmp_path), images=5)
    register_all(str(tmp_path))
    cfg = _workflow_cfg(str(tmp_path))
    host = list(build_detection_test_loader(cfg, "voc_2007_test_all1",
                                            batch_size=2, pin_memory=True))
    assert all(b[0].image.is_pinned() and b[1].boxes.is_pinned()
               for b in host)
    fed = list(device_batches(iter(host), card))
    assert len(fed) == len(host) == 3
    for (images, gt, meta), (h_images, h_gt, h_meta) in zip(fed, host):
        assert images.image.is_cuda and gt.valid.is_cuda
        assert torch.equal(images.image.cpu(), h_images.image)
        assert torch.equal(gt.boxes.cpu(), h_gt.boxes)
        assert meta == h_meta


def _two_gloo_ranks_on_the_card(tasks, tmp_path):
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.launch import (
        launch,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        dryrun_multidevice as dr,
    )

    import tempfile

    store = os.path.join(tempfile.mkdtemp(dir=tmp_path), "store")
    by_rank = launch(dr.tasks_worker, 2, dist_url=f"file://{store}",
                     args=(tasks,), backend="gloo",
                     devices=["cuda:0", "cuda:0"], timeout=300)
    return [list(r) for r in zip(*by_rank)]


def test_all_gather_with_grad_on_cuda_over_two_gloo_ranks(card, tmp_path):
    (got,) = _two_gloo_ranks_on_the_card([("gather", {"device": "cuda:0"})],
                                         tmp_path)
    want = np.repeat(np.array([1.0, 2.0], np.float32), 3)[:, None] * np.ones(
        (1, 4), np.float32)
    for g in got:
        np.testing.assert_array_equal(g["gathered"], want)
        # d/dx of sum over ranks r of sum(gathered * (r + 1)) = 1 + 2
        np.testing.assert_array_equal(g["grad"], np.full((3, 4), 3.0))


def test_two_gloo_ranks_step_on_cuda_matches_one_process(card, tmp_path):
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        dryrun_multidevice as dr,
    )

    torch.backends.cudnn.deterministic = True
    try:
        for kwargs in (dict(dr.TINY, **dr.SAMPLED),
                       dict(dr.TINY, **dr.SAMPLED, **dr.text_kwargs())):
            spec = dict(kwargs=kwargs, state=None, batch=dr.tiny_batch(2),
                        steps=1, device="cuda:0")
            ref = dr.step_worker(spec)
            (got,) = _two_gloo_ranks_on_the_card([("step", spec)], tmp_path)
            dr.check_steps(ref, got, "gloo ranks on cuda:0")
    finally:
        torch.backends.cudnn.deterministic = False


def test_tiny_exact_sgd_step_on_cuda_matches_the_cpu(card):
    """The held-out gate's contract on the two devices: one SGD step of the
    tiny detector under the gfsod gradient contract (GDL lambda_rpn 0,
    lambda_rcnn 0.001, cls dropout), ``make_train_step``'s float32 step on
    CUDA (TF32 off, deterministic algorithms), the sampling and dropout
    drawn on the host (``draw_device="cpu"``): the
    losses of the card's step within 1e-5 relative of the CPU's, every
    gradient within 1e-4 of its largest value, the same ROIs sampled
    (equal sample counts), and a second card run bitwise equal to the
    first."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        make_train_step,
    )

    def run(device):
        model, images, gt = _tiny_detector(
            torch.device(device), rpn_backward_scale=0.0,
            roi_backward_scale=0.001, cls_dropout=True)
        # objectness spread as a trained RPN's: seeded weights score the
        # anchors within float noise of each other, and a near-tie that
        # sorts the other way on one device proposes another box
        logits = model.proposal_generator.rpn_head.objectness_logits
        with torch.no_grad():
            logits.weight.copy_(torch.randn(
                logits.weight.shape, generator=torch.Generator()
                .manual_seed(3)))
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        step = make_train_step(model, opt, seed=5, draw_device="cpu")
        losses = step(images, gt, 3)
        return ({k: float(v) for k, v in losses.items()},
                {n: p.grad.cpu() for n, p in model.named_parameters()
                 if p.grad is not None})

    got, got_g = run("cuda")
    again, again_g = run("cuda")
    ref, ref_g = run("cpu")
    # exact: a second run on the card is bitwise the first
    assert again == got
    assert all(torch.equal(again_g[n], g) for n, g in got_g.items())
    for k, v in ref.items():
        if k.startswith(("metric/roi_num", "metric/rpn_num")):
            assert got[k] == v, k  # the same draws chose the same samples
        elif not k.startswith("metric/"):
            assert abs(got[k] - v) <= 1e-5 * abs(v), (k, got[k], v)
    assert got_g.keys() == ref_g.keys()
    for name, g in ref_g.items():
        torch.testing.assert_close(got_g[name], g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()),
                                   msg=name)
