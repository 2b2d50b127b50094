"""A checkpoint written mid-run resumes the same run (the port's Trainer);
split from tests/test_torch_solver.py so that each file is a small share
of one xdist worker."""

import jax
import torch

from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    Trainer,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.solver import (
    build_lr_scheduler,
    param_groups,
)
from tests.test_torch_solver import (  # noqa: F401
    _data,
    _tiny_cfg,
)


def test_checkpoint_resume_continues_the_same_run(tmp_path):
    """4 steps straight equal 2 steps, a new Trainer resuming from the
    checkpoint, and 2 more: the iteration, the optimizer's momentum, the
    scheduler and the step's generators all come back."""
    straight = Trainer(_tiny_cfg(tmp_path / "a", 4), _data(), device="cpu")
    straight.train()
    first = Trainer(_tiny_cfg(tmp_path / "b", 2), _data(), device="cpu")
    first.train()
    assert (tmp_path / "b" / "model_0000001.pth").exists()
    assert (tmp_path / "b" / "last_checkpoint").read_text() == \
        "model_final.pth"
    second = Trainer(_tiny_cfg(tmp_path / "b", 4), _data(), device="cpu")
    second.resume_or_load()
    assert second.start_iter == 2
    assert second.scheduler.last_epoch == 2
    second.train()
    a = straight.model.state_dict()
    b = second.model.state_dict()
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)
    assert straight.optimizer.param_groups[0]["lr"] == \
        second.optimizer.param_groups[0]["lr"]
