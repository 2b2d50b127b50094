"""The gate's sabotaged fine-tune in lockstep with itself on the CPU
(``…_torch/tools/card_vs_cpu.py``); the clean arm's case is in
tests/test_torch_card_vs_cpu.py, split so that each file is a small share
of one xdist worker."""

import pytest

from tests.test_torch_card_vs_cpu import check_lockstep, gate_voc  # noqa: F401


@pytest.mark.parametrize("arm", ["sabotaged"])
def test_lockstep_of_the_cpu_against_itself_has_no_gap(gate_voc, tmp_path,
                                                       arm):
    check_lockstep(gate_voc, tmp_path, arm)
