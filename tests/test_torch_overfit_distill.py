"""The port's two-stage distillation check
(``…_torch/tools/overfit_distill_check.py``) reloads the teacher and
resets the student, at a few steps; split from
tests/test_torch_overfit.py so that each file is a small share of one
xdist worker."""

import numpy as np
import pytest

from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    overfit_distill_check as port_distill,
)
from tests.test_torch_overfit import (  # noqa: F401
    _json_line,
)


def test_overfit_distill_check_reloads_and_resets_the_student(capsys):
    """Plumbing on the CPU: 2 steps a stage; stage 2 starts from stage 1's
    checkpoint with the student drawn afresh; two logged values cannot
    show a falling loss, so the check fails."""
    with pytest.raises(AssertionError, match="did not decrease"):
        port_distill.main(["--device", "cpu", "--opts", "SOLVER.MAX_ITER",
                           "2"])
    out = _json_line(capsys.readouterr().out)
    assert out["reset_tensors"] >= 6
    assert np.isfinite(out["loss_kl"] + out["loss_student_feat"]).all()
