"""The held-out generalization gates of the port, on the CPU: the port's
``check_generalization.sh``, ``check_generalization_coco.sh`` and
``run_stats_protocol.sh`` (the JAX package's floors, margins and banners)
as ``tests/test_generalization_gate.py`` and ``tests/test_stats_protocol.py``
run the JAX package's scripts, with ``DEVICE=cpu``:

  * the flagship legs: base training -> surgery -> control evaluation ->
    gfsod 10-shot fine-tune -> paired statistics -> same-seed sabotage A/B
    -> SematicRes5ROIHeads fine-tune -> PCB with a learned extractor;
  * the text legs: GeneralizedTextRCNN teacher base training (GT painted),
    the serving-path evaluation (TEST.NO_GT_EVAL), the two-stage cold
    student distillation;
  * the COCO gate: 60-class base -> 60 -> 80 surgery -> gfsod 10-shot ->
    bAP/nAP floors and paired statistics;
  * the multi-seed protocol with its paired multi-seed sabotage A/B
    (STATS_AB=1).

Each trains the tiny model for 1200-iteration runs: minutes to an hour on
the CPU. Marked `gate` (the root conftest.py marks them `slow` too), so
Tier-1 leaves them out; run them with ``pytest tests/ -m gate``.
"""

import os
import subprocess

import pytest

pytestmark = pytest.mark.gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = "fewshotobjectdetection_imporove_via_text_feature_torch/tools"


def _run(script, save, timeout, **env):
    r = subprocess.run(
        ["bash", f"{TOOLS}/{script}", save], cwd=REPO,
        env=dict(os.environ, DEVICE="cpu", **env), capture_output=True,
        text=True, timeout=timeout)
    return r, (r.stdout + r.stderr)[-8000:]


def _run_gate(tmp_path, legs):
    r, tail = _run("check_generalization.sh", str(tmp_path / "gen"), 5400,
                   GEN_LEGS=legs)
    assert r.returncode == 0, tail
    assert "GENERALIZATION GATE PASSED" in r.stdout, tail
    return r.stdout


def test_heldout_generalization_gate_flagship(tmp_path):
    out = _run_gate(tmp_path, "base,control,ft,stats,ab,semantic,pcb")
    assert "PAIRED STATS OK" in out
    assert "SABOTAGE DETECTED" in out
    assert "SEMANTIC LEG PASSED" in out
    assert "PCB LEG PASSED" in out


def test_heldout_generalization_gate_text_family(tmp_path):
    out = _run_gate(tmp_path, "text,serving,distill")
    assert "SERVING LEG PASSED" in out
    assert "DISTILL LEG PASSED" in out


def test_heldout_generalization_gate_coco(tmp_path):
    r, tail = _run("check_generalization_coco.sh", str(tmp_path / "gencoco"),
                   7200)
    assert r.returncode == 0, tail
    assert "COCO PAIRED STATS OK" in r.stdout, tail
    assert "COCO GENERALIZATION GATE PASSED" in r.stdout, tail


def test_multiseed_stats_protocol_with_paired_ab(tmp_path):
    r, tail = _run("run_stats_protocol.sh", str(tmp_path / "stats"), 10800,
                   STATS_AB="1")
    assert r.returncode == 0, tail
    assert "STATS AGGREGATION OK" in r.stdout, tail
    assert "PAIRED MULTI-SEED SABOTAGE DETECTED" in r.stdout, tail
    assert "STATS PROTOCOL PASSED" in r.stdout, tail
