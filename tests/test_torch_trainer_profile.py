"""TPU.PROFILE_START_STEP: the profile window writes a trace, and a resume
inside the window does not; the trace holds the step's spans. Split from
tests/test_torch_trainer_knobs.py so that each file is a small share of
one xdist worker."""

import json
import os

from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
    Trainer,
)
from test_torch_solver import _data, _tiny_cfg


def _traces(out):
    d = os.path.join(out, "profile")
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def test_profile_window_writes_a_trace_and_a_resume_inside_it_does_not(
        tmp_path):
    cfg = _tiny_cfg(tmp_path / "a", 4, period=0)
    cfg.TPU.PROFILE_START_STEP = 1
    cfg.TPU.PROFILE_NUM_STEPS = 2
    Trainer(cfg, _data(), device="cpu").train()
    assert _traces(cfg.OUTPUT_DIR) == ["trace_to_iter_0000002.json"]
    assert os.path.getsize(os.path.join(
        cfg.OUTPUT_DIR, "profile", "trace_to_iter_0000002.json")) > 0

    # two steps, then a resume at step 2 inside the window 1..3: the
    # resumed run started no trace, so it stops none and writes none
    out = tmp_path / "b"
    Trainer(_tiny_cfg(out, 2), _data(), device="cpu").train()
    cfg = _tiny_cfg(out, 4, period=0)
    cfg.TPU.PROFILE_START_STEP = 1
    cfg.TPU.PROFILE_NUM_STEPS = 3
    resumed = Trainer(cfg, _data(), device="cpu")
    resumed.resume_or_load()
    assert resumed.start_iter == 2
    resumed.train()
    assert _traces(cfg.OUTPUT_DIR) == []

    # a window that runs past the last step is stopped at the end
    cfg = _tiny_cfg(tmp_path / "c", 2, period=0)
    cfg.TPU.PROFILE_START_STEP = 1
    cfg.TPU.PROFILE_NUM_STEPS = 5
    Trainer(cfg, _data(), device="cpu").train()
    assert _traces(cfg.OUTPUT_DIR) == ["trace_to_iter_0000001.json"]


def test_profile_window_trace_holds_the_train_spans(tmp_path):
    # steps 0 and 1, the window on step 1: it logs (the last step) and
    # saves (CHECKPOINT_PERIOD 2) inside the window
    cfg = _tiny_cfg(tmp_path, 2, period=2)
    cfg.TPU.PROFILE_START_STEP = 1
    cfg.TPU.PROFILE_NUM_STEPS = 1
    Trainer(cfg, _data(), device="cpu").train()
    path = os.path.join(cfg.OUTPUT_DIR, "profile",
                        "trace_to_iter_0000001.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("fsod.")]
    assert sorted(n for n in names if n.startswith("fsod.train.")) == [
        "fsod.train.backward", "fsod.train.checkpoint", "fsod.train.fetch",
        "fsod.train.forward", "fsod.train.log", "fsod.train.optimizer"]
    assert "fsod.backbone" in names and "fsod.roi_heads" in names
