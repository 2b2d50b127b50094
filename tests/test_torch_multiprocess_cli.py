"""The port's command line and dry run on several CPU ranks (gloo), the
counterpart of tests/test_multihost.py: ``--num-gpus 2`` trains and
evaluates the tiny detector on a synthetic VOC with the same losses on
both ranks and rank-0-only outputs; ``tools/dryrun_multidevice.py`` passes
at 2 and 4 ranks; ``launch`` fails, and stops its ranks, when a rank dies
or runs past its time. Every spawn joins through a file store under
tmp_path and is stopped after at most 120 s."""

import json
import os
import subprocess
import sys
import time

import pytest

from fewshotobjectdetection_imporove_via_text_feature_torch.engine.launch import (
    launch,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    dryrun_multidevice,
)
from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_voc import (
    make_voc,
)
from tests.test_torch_eval_cli import BASE1, TINY_OPTS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


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
    rank 0 saves one resumable checkpoint, and the run exits 0."""
    import signal

    import torch

    voc = str(tmp_path / "voc")
    make_voc(voc, images=6)
    out = tmp_path / "out"
    argv = [sys.executable, "-m",
            "fewshotobjectdetection_imporove_via_text_feature_torch.cli",
            "--num-gpus", "2", "--dist-url", f"file://{tmp_path}/store",
            "--config-file", BASE1, "--opts", *TINY_OPTS,
            "SOLVER.MAX_ITER", "100000", "OUTPUT_DIR", str(out)]
    env = dict(os.environ, FSODTF_DATASETS=voc, PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    with open(tmp_path / "log", "w") as log:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + TIMEOUT
            while not (out / "metrics.json").exists():
                assert proc.poll() is None, (tmp_path / "log").read_text()
                assert time.monotonic() < deadline, "no step in time"
                time.sleep(0.5)
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=TIMEOUT) == 0, \
                (tmp_path / "log").read_text()[-3000:]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    saved = sorted(out.glob("model_*.pth"))
    assert len(saved) == 1 and "final" not in saved[0].name, saved
    state = torch.load(saved[0], weights_only=True)
    assert saved[0].name == f"model_{state['iteration']:07d}.pth"
    assert (out / "last_checkpoint").read_text().strip() == saved[0].name


@pytest.mark.parametrize("ranks", [2, 4])
def test_dryrun_multidevice(tmp_path, capsys, ranks):
    assert dryrun_multidevice.main(["--ranks", str(ranks), "--workdir",
                                    str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "dryrun_multidevice: ok"
    assert any(f"mesh ({ranks // 2}, 2)" in ln for ln in lines)


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
