"""The base leg's lockstep of the CPU against itself, resynced
(``…_torch/tools/card_vs_cpu.py``); split from
tests/test_torch_card_vs_cpu.py so that each file is a small share of
one xdist worker."""

import pytest

from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    card_vs_cpu,
)
from tests.test_torch_card_vs_cpu import (  # noqa: F401
    gate_voc,
)


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
    # each resynced step's update by parameter group: no gap, the same
    # length and direction, so no step is over the tolerance
    assert res["first_group_over"] is None
    assert res["synced_equal_counts"] == 2
    for g in res["group_updates"].values():
        assert g["gap_max"] == 0.0 and g["norm_ratio_median"] == 1.0
        assert g["card_longer_share"] == 0.0
        assert g["cos_median"] == pytest.approx(1.0, abs=1e-12)
    assert res["card_loss_above_share"] == 0.0
