"""The card-against-CPU instruments of the held-out gate
(``…_torch/tools/card_vs_cpu.py``, ``chip_smoke.py`` phase 18), on the CPU.

Where the card is absent the CPU stands in for it: the lockstep of the gate's
clean fine-tune against itself must show no gap at all (the same decoded
batches, the same host draws), so a gap on the card is the card's. A step's
draws made on a host generator and copied to the step's device
(``parallel.local_rand``) are the host's own numbers, and the step the
card runs in lockstep (``make_train_step(draw_device="cpu")``; on CUDA a
float32 step runs with TF32 off and deterministic algorithms) is on the
CPU the step it always was. The legs' settings are read from the gate
script. The two decode paths of the mapper differ on the gate's images by
PIL's antialiased downscale at the 224-pixel scale and by one grey level
of rounding at 256 and 288.
"""

import pytest
import torch

from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
    native_io,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.parallel.collectives import (
    local_rand,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    card_vs_cpu,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    make_generalization_voc as gen_voc,
)


@pytest.fixture(scope="module")
def gate_voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("gate_voc")
    gen_voc.make_generalization_voc(str(root), val=8)
    return str(root)


def test_a_host_generator_draws_its_own_numbers_for_any_device():
    want = torch.rand((3, 7), generator=torch.Generator().manual_seed(4))
    got = local_rand((3, 7), torch.Generator().manual_seed(4), "cpu")
    assert torch.equal(got, want)
    # no generator: the device's global stream, as before
    assert local_rand((2, 2), None, "cpu").shape == (2, 2)


def _tiny_step(draw_device):
    """Two SGD steps of a tiny detector under the gfsod contract (GDL
    lambda_rcnn 0.001, cls dropout), drawing on ``draw_device``: their
    losses and the parameters."""
    import numpy as np

    from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint import (
        init_weights,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        make_train_step,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.models import (
        GeneralizedRCNN,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.structures import (
        GTInstances,
        ImageBatch,
    )

    model = GeneralizedRCNN(
        num_classes=5, depth=14, stem_out_channels=8, res2_out_channels=16,
        width_per_group=4, freeze_at=0, rpn_pre_nms_topk=(600, 600),
        rpn_post_nms_topk=(100, 100), roi_batch_per_image=64,
        roi_backward_scale=0.001, cls_dropout=True)
    init_weights(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(7)
    images = ImageBatch(
        image=torch.from_numpy(rng.uniform(0, 255, (2, 128, 160, 3))
                               .astype(np.float32)),
        hw=torch.tensor([[128, 160], [96, 128]], dtype=torch.int32),
        orig_hw=torch.tensor([[128, 160], [96, 128]], dtype=torch.int32))
    xy = rng.uniform(0, 80, (2, 4, 2))
    gt = GTInstances(
        boxes=torch.from_numpy(np.concatenate(
            [xy, xy + rng.uniform(16, 40, (2, 4, 2))], -1)
            .astype(np.float32)),
        classes=torch.from_numpy(rng.randint(0, 5, (2, 4)).astype(np.int32)),
        valid=torch.ones((2, 4), dtype=torch.bool))
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    step = make_train_step(model.train(), opt, seed=5,
                           draw_device=draw_device)
    losses = [step(images, gt, it) for it in range(2)]
    return losses, [p.detach().clone() for p in model.parameters()]


def test_an_exact_step_on_the_cpu_is_the_plain_step():
    (l0, p0), (l1, p1) = _tiny_step(None), _tiny_step("cpu")
    for a, b in zip(l0, l1):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert float(l0[0]["loss_cls"]) > 0
    # a CPU step sets no flag of the card's exact float32
    assert not torch.are_deterministic_algorithms_enabled()


def test_gate_config_is_the_ft_and_ab_legs():
    clean = card_vs_cpu.gate_cfg("w.pth", "clean", 7, "cpu")
    sab = card_vs_cpu.gate_cfg("w.pth", "sabotaged", 7, "cpu")
    assert (clean.MODEL.RPN.BACKWARD_SCALE, clean.MODEL.ROI_HEADS
            .BACKWARD_SCALE, clean.MODEL.ROI_HEADS.FREEZE_FEAT,
            clean.MODEL.ROI_HEADS.CLS_DROPOUT) == (0.0, 0.001, True, True)
    assert (sab.MODEL.RPN.BACKWARD_SCALE, sab.MODEL.ROI_HEADS.BACKWARD_SCALE,
            sab.MODEL.ROI_HEADS.FREEZE_FEAT) == (1.0, 1.0, False)
    for cfg in (clean, sab):
        assert cfg.SEED == 7 and cfg.MODEL.DEVICE == "cpu"
        assert cfg.MODEL.BACKBONE.FREEZE_AT == 0
        assert cfg.SOLVER.MAX_ITER == 500 and cfg.SOLVER.STEPS == (400,)
        assert (cfg.SOLVER.BASE_LR, cfg.SOLVER.WARMUP_ITERS) == (0.01, 50)
        assert cfg.DATASETS.TRAIN == ("voc_2007_trainval_all1_10shot_seed0",)
    # the base leg: from the seed's initial weights, the script's solver
    base = card_vs_cpu.gate_cfg("", "base", 9, "cpu")
    assert base.MODEL.WEIGHTS == "" and base.SEED == 9
    assert base.SOLVER.MAX_ITER == 1200 and base.SOLVER.STEPS == (900, 1080)
    assert (base.SOLVER.BASE_LR, base.SOLVER.WARMUP_ITERS) == (0.01, 100)
    assert base.DATASETS.TRAIN == ("voc_2007_trainval_base1",
                                   "voc_2012_trainval_base1")
    assert base.MODEL.ROI_HEADS.NUM_CLASSES == 15
    with pytest.raises(ValueError, match="one of clean, sabotaged, base"):
        card_vs_cpu.leg_opts("half")


@pytest.mark.parametrize("arm", ["clean", "sabotaged"])
def test_lockstep_of_the_cpu_against_itself_has_no_gap(gate_voc, tmp_path,
                                                       arm):
    res = card_vs_cpu.lockstep("", gate_voc, 3, arm=arm, card_device="cpu",
                               out_dir=str(tmp_path))
    first = res["first_step"]
    assert first["loss_rel"] == 0.0 and first["grad_err"] == 0.0
    assert first["grad_max"] > 0
    assert res["max_total_rel"] == 0.0
    assert [r["step"] for r in res["steps"]] == [0, 1, 2]
    assert res["counts_differ_at"] == []
    assert set(res["weights"]) == {"card", "cpu"}
    saved = [torch.load(p) for p in res["weights"].values()]
    assert all(torch.equal(saved[0][n], t) for n, t in saved[1].items())
    groups = res["steps"][-1]["groups"]
    assert set(groups) == {"stem", "res2-res4", "res5", "rpn",
                           "box_predictor"}
    assert all(g["gap"] == 0.0 for g in groups.values())
    assert groups["box_predictor"]["moved"] > 0
    # FREEZE_FEAT: the clean arm never moves res5; the sabotaged arm does
    assert (groups["res5"]["moved"] > 0) == (arm == "sabotaged")


def test_a_resynced_base_leg_lockstep_of_the_cpu_has_no_gap(gate_voc,
                                                            tmp_path):
    # the base leg from the seed's initial weights (at batch 2: the
    # plumbing, cheaply), the card handed the CPU's parameters and
    # momentum before steps 1 and 2, free at step 3
    res = card_vs_cpu.lockstep("", gate_voc, 4, arm="base", seed=9,
                               opts=("SOLVER.IMS_PER_BATCH", "2"),
                               card_device="cpu", out_dir=str(tmp_path),
                               resync=3)
    assert res["max_total_rel"] == 0.0 and res["max_update_rel"] == 0.0
    assert [r.get("update_rel") for r in res["steps"]] == [None, 0.0, 0.0,
                                                           None]
    groups = res["steps"][-1]["groups"]
    assert all(g["gap"] == 0.0 and g["moved"] > 0 for g in groups.values())


@pytest.mark.skipif(not native_io.available(),
                    reason="the native data-IO core does not build here")
def test_pil_and_the_native_core_differ_by_the_antialiased_downscale(
        gate_voc):
    gaps = card_vs_cpu.decoder_gaps(gate_voc)
    assert gaps["images"] == 188
    for short in ("256", "288"):  # upscales: rounding only
        assert gaps[short]["max_abs"] <= 1.0
    assert gaps["224"]["max_abs"] > 1.0  # PIL filters a downscale
    assert all(g["mean_abs"] < 0.5 for k, g in gaps.items() if k != "images")
