"""The conv-by-conv replay of a gate step and the exact float32 step on the
CPU (``…_torch/tools/card_vs_cpu.py``); split from
tests/test_torch_card_vs_cpu.py so that each file is a small share of
one xdist worker."""

import torch

from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    card_vs_cpu,
)
from tests.test_torch_card_vs_cpu import (  # noqa: F401
    _tiny_step,
    gate_voc,
)


def test_an_exact_step_on_the_cpu_is_the_plain_step():
    (l0, p0), (l1, p1) = _tiny_step(None), _tiny_step("cpu")
    for a, b in zip(l0, l1):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert float(l0[0]["loss_cls"]) > 0
    # a CPU step sets no flag of the card's exact float32
    assert not torch.are_deterministic_algorithms_enabled()


def test_convs_of_the_cpu_against_itself_have_no_gap(gate_voc, tmp_path):
    # at batch 2: the plumbing, cheaply
    res = card_vs_cpu.conv_errors("", gate_voc, 1, arm="sabotaged",
                                  opts=("SOLVER.IMS_PER_BATCH", "2"),
                                  card_device="cpu", out_dir=str(tmp_path))
    names = [r["name"] for r in res["convs"]]
    assert names[0] == "backbone.stem.conv1.weight"
    assert any(n.startswith("roi_heads.res5.") for n in names)
    assert res["losses"]["card"] == res["losses"]["cpu"]
    assert all(g == 0.0 for _, g in res["grad_gaps"])
    for r in res["convs"]:
        assert r["x_gap"] == 0.0 and r["gy_gap"] == 0.0
        assert r["card"] == r["cpu"]
        assert max(r["cpu"].values()) < 1e-4
