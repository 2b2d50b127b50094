"""The port's command line on several CPU ranks (gloo), the counterpart
of tests/test_multihost.py: ``--num-gpus 2`` trains and evaluates the tiny
detector on a synthetic VOC with the same losses on both ranks and
rank-0-only outputs, and a SIGTERM stops both ranks after the same step;
``launch`` fails, and stops its ranks, when a rank dies or runs past its
time (the dry run at 2 and 4 ranks: tests/test_torch_multiprocess_dryrun.py).
Every spawn joins through a file store under tmp_path and is stopped
after at most 120 s, or, for the SIGTERM run, its step bound."""

import json
import os
import subprocess
import sys
import time

import pytest

from fewshotobjectdetection_imporove_via_text_feature_torch.engine.launch import (
    launch,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_voc import (
    make_voc,
)
from tests.test_torch_eval_cli import BASE1, TINY_OPTS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
# the SIGTERM run: the steps it may take after the signal (its metrics log
# every 20), and the bound that ends a run that hangs
SIGTERM_STEPS = 20
HANG_GUARD = 600


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_cli_trains_and_evaluates_on_two_cpu_ranks(tmp_path, model_parallel):
    """DDP, or FSDP2 with TPU.MODEL_PARALLEL 2 (its checkpoint gathered to
    rank 0, its evaluation on a whole copy of the model); the stages below
    FREEZE_AT 2 get no gradient."""
    voc = str(tmp_path / "voc")
    make_voc(voc, images=6)
    out = tmp_path / "out"
    argv = [sys.executable, "-m",
            "fewshotobjectdetection_imporove_via_text_feature_torch.cli",
            "--num-gpus", "2", "--dist-url", f"file://{tmp_path}/store",
            "--config-file", BASE1, "--opts", *TINY_OPTS,
            "MODEL.BACKBONE.FREEZE_AT", "2",
            "TPU.MODEL_PARALLEL", str(model_parallel),
            "SOLVER.MAX_ITER", "2", "SOLVER.STEPS", "(1,)",
            "OUTPUT_DIR", str(out)]
    env = dict(os.environ, FSODTF_DATASETS=voc, PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    run = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert run.returncode == 0, run.stderr[-3000:]
    main, other = _records(out / "metrics.json"), _records(
        out / "rank1" / "metrics.json")
    assert [r["iteration"] for r in main] == [0, 1]
    for a, b in zip(main, other):  # the global batch's losses on both
        assert {k: v for k, v in a.items() if k != "time_since_last_log"} \
            == {k: v for k, v in b.items() if k != "time_since_last_log"}
    assert main[0]["loss_cls"] > 0
    assert (out / "model_final.pth").exists()
    assert not list((out / "rank1").glob("*.pth"))
    lines = [ln.strip() for ln in open(out / "log.txt") if ln.strip()]
    assert "copypaste" in lines[-1] and "copypaste" in lines[-2], lines[-3:]
    rank1 = [ln.strip() for ln in open(out / "rank1" / "log.txt")
             if ln.strip()]
    # the same metrics on both ranks
    assert rank1[-1].split("copypaste:")[1] == lines[-1].split("copypaste:")[1]


def test_sigterm_stops_both_ranks_after_the_same_step(tmp_path):
    """A SIGTERM to the launching process reaches both ranks; they stop
    after the same step (a rank left behind would wait in a collective),
    rank 0 saves one resumable checkpoint, and the run exits 0.

    The run's length is a step count: SOLVER.MAX_ITER bounds it, so it
    ends whether or not the signal stops it, and the test waits on its
    steps, not on a clock. The signal goes out once step 0 is logged; a
    run that went on for SIGTERM_STEPS more steps logs step SIGTERM_STEPS
    and fails, as does one that ran to the end (model_final). HANG_GUARD
    only ends a run that stopped making progress (a deadlock)."""
    import signal

    import torch

    voc = str(tmp_path / "voc")
    make_voc(voc, images=6)
    out = tmp_path / "out"
    argv = [sys.executable, "-m",
            "fewshotobjectdetection_imporove_via_text_feature_torch.cli",
            "--num-gpus", "2", "--dist-url", f"file://{tmp_path}/store",
            "--config-file", BASE1, "--opts", *TINY_OPTS,
            "SOLVER.MAX_ITER", str(3 * SIGTERM_STEPS),
            "OUTPUT_DIR", str(out)]
    env = dict(os.environ, FSODTF_DATASETS=voc, PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")

    def logged_steps():
        path = out / "metrics.json"
        return [r["iteration"] for r in _records(path)] if path.exists() \
            else []

    with open(tmp_path / "log", "w") as log:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            guard = time.monotonic() + HANG_GUARD
            while not logged_steps():
                assert proc.poll() is None, (tmp_path / "log").read_text()
                assert time.monotonic() < guard, "no progress: a hang"
                time.sleep(0.2)
            proc.send_signal(signal.SIGTERM)
            while proc.poll() is None:
                assert max(logged_steps()) < SIGTERM_STEPS, \
                    f"the run took {SIGTERM_STEPS} steps after SIGTERM"
                assert time.monotonic() < guard, "no progress: a hang"
                time.sleep(0.2)
            assert proc.returncode == 0, \
                (tmp_path / "log").read_text()[-3000:]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    saved = sorted(out.glob("model_*.pth"))
    assert len(saved) == 1 and "final" not in saved[0].name, saved
    state = torch.load(saved[0], weights_only=True)
    assert saved[0].name == f"model_{state['iteration']:07d}.pth"
    assert state["iteration"] < SIGTERM_STEPS
    assert logged_steps() == [0]
    assert (out / "last_checkpoint").read_text().strip() == saved[0].name


def test_launch_fails_when_a_rank_dies(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited with code 3"):
        launch(os._exit, 2, dist_url=f"file://{tmp_path}/store", args=(3,),
               backend="gloo", devices=["cpu", "cpu"], timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT


def test_launch_stops_ranks_that_run_past_their_time(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        launch(time.sleep, 2, dist_url=f"file://{tmp_path}/store",
               args=(600,), backend="gloo", devices=["cpu", "cpu"],
               timeout=10)
    assert time.monotonic() - t0 < 60


def test_launch_refuses_auto_url_across_machines():
    with pytest.raises(ValueError, match="dist-url"):
        launch(time.sleep, 2, num_machines=2, args=(0,))
