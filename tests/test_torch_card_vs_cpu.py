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

The gate's statistic over seeds (``sweep``, ``collect``, ``compare``): a
seed's record is read from its legs' logs, which both packages' gate
scripts write in one layout; a failed leg is a record with its exit code;
the bootstrap intervals hold the null for equal populations, exclude it
for a shift of 3 SD, and come out the same every time.
"""

import json
import math
import os
import pickle

import numpy as np
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


# the sabotaged arm's case is in test_torch_card_vs_cpu_lockstep.py
@pytest.mark.parametrize("arm", ["clean"])
def test_lockstep_of_the_cpu_against_itself_has_no_gap(gate_voc, tmp_path,
                                                       arm):
    check_lockstep(gate_voc, tmp_path, arm)


def check_lockstep(gate_voc, tmp_path, arm):
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


# --------------------------------------------- the statistic over seeds --
_HEADS = {"base1.log": "AP,AP50,AP75,bAP,bAP50,bAP75",
          "10shot_seed0.log": "AP,AP50,AP75,bAP,bAP50,bAP75,nAP,nAP50,nAP75",
          "ab_sab.log": "AP,AP50,AP75,bAP,bAP50,bAP75,nAP,nAP50,nAP75"}
_ROWS = {"base1.log": [68.1833, 92.6777, 75.6671, 68.1833, 92.6777, 75.6671],
         "10shot_seed0.log": [60.5, 85.25, 66.0, 64.75, 90.5, 70.0, 48.0,
                              80.0, 50.0],
         "ab_sab.log": [58.0, 84.0, 63.0, 61.5, 89.0, 66.0, 47.0, 79.5,
                        49.0]}


def _gate_dir(root, logger, seed, legs=tuple(_ROWS), rows=None,
              verdict="passed"):
    """A gate directory as either package's script leaves it: each leg's
    log (``logger``: the CLI's logger name) with its ``copypaste:`` rows
    and the leg's ``config.yaml``."""
    rows = dict(_ROWS, **(rows or {}))
    os.makedirs(root, exist_ok=True)
    for i, name in enumerate(legs):
        out = os.path.join(root, name[:-4])
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "config.yaml"), "w") as f:
            f.write(f"MODEL:\n  DEVICE: cpu\nSEED: {seed}\n")
        stamp = lambda s: f"2026-10-18 05:{10 + i:02d}:{s:06.3f}".replace(
            ".", ",")
        lines = [f"{stamp(1.5)} {logger} INFO: iter 0  total_loss: 6.0"]
        if rows[name] is not None:
            lines += [f"{stamp(20.25)} {logger} INFO: copypaste: Task: bbox",
                      f"{stamp(20.25)} {logger} INFO: copypaste: "
                      f"{_HEADS[name]}",
                      f"{stamp(20.25)} {logger} INFO: copypaste: "
                      + ",".join(f"{v:.4f}" for v in rows[name]),
                      f"{stamp(21.75)} {logger} INFO: Result verification "
                      + (verdict if name == "base1.log" else "passed") + "."]
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")


def test_collect_reads_port_and_jax_gate_logs_alike(tmp_path):
    _gate_dir(str(tmp_path / "port" / "s7"), "fsodtf_torch", 7)
    _gate_dir(str(tmp_path / "jax" / "run_a"), "fsodtf_tpu", 7)
    port = card_vs_cpu.collect(str(tmp_path / "port"),
                               str(tmp_path / "port.jsonl"))
    jax_ = card_vs_cpu.collect(str(tmp_path / "jax"))
    assert port == jax_ and len(port) == 1
    rec = port[0]
    assert rec["seed"] == 7  # from the legs' config.yaml
    assert (rec["base_ap"], rec["base_ap50"]) == (68.1833, 92.6777)
    assert (rec["clean_bap"], rec["clean_bap50"]) == (64.75, 90.5)
    assert (rec["sab_bap"], rec["sab_bap50"]) == (61.5, 89.0)
    assert rec["d"] == pytest.approx(3.25)
    assert {k: v["rc"] for k, v in rec["legs"].items()} == {
        "base": 0, "ft": 0, "ab": 0}
    assert all(v["wall_s"] == 20.25 for v in rec["legs"].values())
    assert card_vs_cpu.read_records(str(tmp_path / "port.jsonl")) == port


@pytest.mark.parametrize("case", ["base_below_floor", "ft_crashed",
                                  "ab_under_margin"])
def test_a_failed_leg_is_a_record_with_its_exit_code(tmp_path, case):
    if case == "base_below_floor":  # set -e: ft and ab never ran
        _gate_dir(str(tmp_path), "fsodtf_torch", 9, legs=("base1.log",),
                  verdict="failed: bbox/AP50 = 41.0000")
        want = {"base": 1, "ft": None, "ab": None}
    elif case == "ft_crashed":
        _gate_dir(str(tmp_path), "fsodtf_torch", 9,
                  legs=("base1.log", "10shot_seed0.log"),
                  rows={"10shot_seed0.log": None})
        want = {"base": 0, "ft": 1, "ab": None}
    else:  # the A/B's assert: d = 0.5 < SAB_MARGIN 1
        _gate_dir(str(tmp_path), "fsodtf_torch", 9, rows={
            "ab_sab.log": [0, 0, 0, 64.25, 90.0, 0, 0, 0, 0]})
        want = {"base": 0, "ft": 0, "ab": 1}
    rec = card_vs_cpu.gate_record(str(tmp_path))
    assert rec["seed"] == 9
    assert {k: v["rc"] for k, v in rec["legs"].items()} == want
    assert (rec["d"] is None) == (case != "ab_under_margin")
    if case == "ab_under_margin":
        assert rec["d"] == pytest.approx(0.5)


_FAKE_GATE = """#!/usr/bin/env bash
# a stand-in for the gate script: its knobs, its env, its legs' logs
SAB_MARGIN=${SAB_MARGIN:-1}
mkdir -p "$1"
env | grep -E '^(GEN_|DEVICE=|OMP_NUM_THREADS=)' | sort > "$1/env.txt"
for leg in ${GEN_LEGS//,/ }; do cp -r %(tpl)s/$leg/. "$1"/; done
exit 1  # as the A/B assert would
"""


def test_sweep_appends_a_record_a_seed_with_the_script_exit_code(
        tmp_path, monkeypatch):
    tpl = tmp_path / "tpl"
    for leg, log in (("base", "base1.log"), ("ft", "10shot_seed0.log"),
                     ("ab", "ab_sab.log")):
        _gate_dir(str(tpl / leg), "fsodtf_torch", 0, legs=(log,))
    script = tmp_path / "gate.sh"
    script.write_text(_FAKE_GATE % {"tpl": tpl})
    monkeypatch.setattr(card_vs_cpu, "GATE_SCRIPT", str(script))
    assert card_vs_cpu.parse_seeds("5-7,9") == [5, 6, 7, 9]
    out = tmp_path / "runs.jsonl"
    recs = card_vs_cpu.sweep("cpu", [5, 6], str(out), jobs=2)
    assert [r["seed"] for r in recs] == [5, 6]
    assert sorted(r["seed"] for r in card_vs_cpu.read_records(
        str(out))) == [5, 6]
    for r in recs:
        assert r["script_rc"] == 1 and r["device"] == "cpu"
        assert r["d"] == pytest.approx(3.25) and r["cached_base"] is None
        env = (tmp_path / "runs" / f"s{r['seed']}" / "env.txt").read_text()
        assert f"GEN_SEED={r['seed']}" in env and "DEVICE=cpu" in env
        assert "GEN_LEGS=base,ft,ab" in env
        assert f"OMP_NUM_THREADS={max(1, (os.cpu_count() or 1) // 2)}" \
            in env
    # cached bases: the ft and ab legs from the seed's JAX package base,
    # handed to the script as the state dict MODEL.WEIGHTS would load
    bases = tmp_path / "bases" / "s8" / "base1"
    bases.mkdir(parents=True)
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    with open(bases / "model_reset_surgery.ckpt", "wb") as f:
        pickle.dump({"params": {"roi_heads": {"box_predictor": {
            "cls_score": {"kernel": w, "bias": np.ones(3, np.float32)}}}}},
            f)
    (rec,) = card_vs_cpu.sweep("cpu", [8], str(tmp_path / "c.jsonl"),
                               bases=str(tmp_path / "bases"))
    env = (tmp_path / "c" / "s8" / "env.txt").read_text()
    assert "GEN_LEGS=ft,ab" in env
    assert f"GEN_CACHED_BASE={rec['cached_base']}" in env
    assert rec["base_ap"] is None and rec["legs"]["base"]["rc"] is None
    state = torch.load(rec["cached_base"])["model"]
    assert torch.equal(state["roi_heads.box_predictor.cls_score.weight"],
                       torch.from_numpy(w.T.copy()))


def _records(values, key="d", seeds=None):
    seeds = seeds if seeds is not None else range(5, 5 + len(values))
    return [{"seed": s, key: float(v), "base_ap": float(v)}
            for s, v in zip(seeds, values)]


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("shift_sd", [0.0, 3.0])
def test_compare_interval_holds_zero_for_equal_means_only(paired,
                                                          shift_sd):
    rng = np.random.default_rng(11)
    a = rng.normal(4.0, 2.0, 24)
    if paired:  # the same seeds: B is A plus noise of SD 1 and the shift
        noise = rng.normal(0.0, 1.0, 24)
        b = a + noise - noise.mean() + shift_sd * 1.0
    else:  # B's own draw of SD 2, its mean set to A's plus the shift
        b = rng.normal(4.0, 2.0, 24)
        b += a.mean() - b.mean() + shift_sd * 2.0
    res = card_vs_cpu.compare(_records(a), _records(b), paired=paired)
    assert res["n_seeds"] == {"A": 24, "B": 24}
    key, ci = (("delta_f", res["paired_d"]["ci"]) if paired
               else ("delta_d", res["d"]["delta"]["ci"]))
    assert res["null_held"][key] == (shift_sd == 0.0)
    assert (ci[0] <= 0.0 <= ci[1]) == (shift_sd == 0.0)
    assert res["d"]["A"]["n"] == 24 and res["d"]["A"]["ci"][0] < 4.5
    # spreads alike: the SD ratio's interval holds 1
    assert res["null_held"]["sd_ratio_b"]
    assert 0.0 <= res["d"]["pass_share"]["A"] <= 1.0
    assert 0.0 < res["d"]["mw_p"] <= 1.0
    if shift_sd and not paired:
        assert res["d"]["mw_p"] < 0.01
    # reproducible: default_rng(0) resamples the seeds the same way
    again = card_vs_cpu.compare(_records(a), _records(b), paired=paired)
    assert json.dumps(again) == json.dumps(res)


def test_compare_pass_share_sd_ratio_and_missing_d():
    a = _records([3.0, 0.5, 2.0, 1.0])
    b = _records([-2.0, 4.0, 0.0, 9.0])
    b.append({"seed": 20, "d": None, "base_ap": 50.0})  # base leg failed
    res = card_vs_cpu.compare(a, b)
    assert res["d"]["pass_share"] == {"A": 0.75, "B": 0.5}
    assert res["d"]["B"]["n"] == 4 and res["b"]["B"]["n"] == 5
    want = np.std([-2.0, 4.0, 0.0, 9.0, 50.0], ddof=1) / np.std(
        [3.0, 0.5, 2.0, 1.0], ddof=1)
    assert res["b"]["sd_ratio"]["value"] == pytest.approx(want)
    assert res["null_held"]["sd_ratio_b"] is False


def test_mann_whitney_p_is_the_normal_approximation():
    # U = 0 of 9 pairs; sd sqrt(9 / 12 * 7), continuity 0.5
    z = (9 - 4.5 - 0.5) / math.sqrt(9 / 12 * 7)
    want = math.erfc(z / math.sqrt(2))
    assert card_vs_cpu.mann_whitney_p([1, 2, 3], [4, 5, 6]) == \
        pytest.approx(want)
    assert card_vs_cpu.mann_whitney_p([1, 2, 3], [1, 2, 3]) == 1.0
    try:
        from scipy.stats import mannwhitneyu
    except ImportError:
        return
    x, y = [0.3, 1.2, 1.2, 4.0, 5.5, 2.0], [1.2, 3.3, 7.0, 8.1, 2.0]
    assert card_vs_cpu.mann_whitney_p(x, y) == pytest.approx(
        mannwhitneyu(x, y, method="asymptotic").pvalue)


def test_resync_summary_finds_the_first_step_over_tolerance():
    def row(step, gap, card_loss=1.0):
        return {"step": step, "card": {"total_loss": card_loss},
                "cpu": {"total_loss": 1.0},
                "update_groups": {"stem": {"gap_rel": gap, "norm_ratio":
                                           1 + gap, "cos": 1.0},
                                  "res5": None}}
    rows = [row(1, 1e-6), row(2, 5e-4), row(3, 2e-4, 1.5), row(4, 1e-7)]
    res = card_vs_cpu.resync_summary(rows, parted={2})
    assert res["first_group_over"] == {"step": 3, "group": "stem",
                                       "gap_rel": 2e-4, "worst": None,
                                       "worst_gap_rel": None}
    assert res["synced_equal_counts"] == 3
    assert res["group_updates"]["stem"]["gap_max"] == 2e-4
    assert res["group_updates"]["stem"]["card_longer_share"] == 1.0
    assert "res5" not in res["group_updates"]
    assert res["card_loss_above_share"] == pytest.approx(1 / 3)
    assert card_vs_cpu.resync_summary(rows[:1], set())[
        "first_group_over"] is None
    a = {"backbone.stem.conv1.weight": torch.zeros(2),
         "roi_heads.res5.0.w": torch.zeros(2)}
    u = card_vs_cpu.update_groups(
        {**a, "backbone.stem.conv1.weight": torch.tensor([2.0, 0.0])},
        {**a, "backbone.stem.conv1.weight": torch.tensor([1.0, 0.0])}, a)
    assert u["stem"] == {"gap_rel": 1.0, "norm_ratio": 2.0, "cos": 1.0,
                         "worst": "backbone.stem.conv1.weight",
                         "worst_gap_rel": 1.0}
    assert u["res5"] is None


def test_conv_tape_records_and_replays_each_convolution():
    """``convs``' parts: every F.conv2d of a forward is recorded with the
    gradient that reached its output, and its float32 replay on the CPU
    gives the autograd's own gradients bitwise."""
    from fewshotobjectdetection_imporove_via_text_feature_torch.models.backbone import (
        Conv2d,
        FrozenBN,
    )

    gen = torch.Generator().manual_seed(3)
    net = torch.nn.Sequential(
        Conv2d(3, 4, 3, padding=1, bias=False, norm=FrozenBN(4)),
        torch.nn.ReLU(), Conv2d(4, 2, 1, stride=2, bias=True))
    for p in net.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen))
    x = torch.randn((2, 3, 12, 10), generator=gen)
    names = {p.data_ptr(): n for n, p in net.named_parameters()}
    tape = card_vs_cpu._conv_tape(names)
    with tape:
        net(x).square().sum().backward()
    assert [r["name"] for r in tape.calls] == ["0.weight", "2.weight"]
    assert all("gy" in r for r in tape.calls)
    assert tape.calls[1]["opts"] == ((2, 2), (0, 0), (1, 1), 1)
    for rec, conv in zip(tape.calls, (net[0], net[2])):
        y, dx, dw = card_vs_cpu._conv_replay(rec, "cpu", torch.float32)
        assert torch.equal(dw, conv.weight.grad.double())
        assert y.shape == rec["gy"].shape and dx.shape == rec["x"].shape
        y64, _, dw64 = card_vs_cpu._conv_replay(rec, "cpu", torch.float64)
        assert float((dw - dw64).norm() / dw64.norm()) < 1e-5


