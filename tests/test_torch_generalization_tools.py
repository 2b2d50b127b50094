"""The port's held-out gate tools against the JAX package's, on the CPU: the
COCO data maker's files, the PCB extractor's crops and its first two Adam
steps at full depth, and a plumbing run of the port's VOC gate script.

The gates themselves (1200-iteration tiny trainings, with the JAX
package's floors) are `gate` tests in ``test_torch_generalization_gate.py``.
"""

import importlib
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    make_generalization_coco as port_gen_coco,
    make_generalization_voc as port_gen_voc,
    train_pcb_extractor as port_pcb,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = "fewshotobjectdetection_imporove_via_text_feature_torch"


@pytest.fixture
def jax_tools(monkeypatch):
    """The repository's ``tools/`` modules, importable as the JAX tools
    import each other, with no persistent compilation cache."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    return importlib.import_module


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def test_make_generalization_coco_writes_the_jax_tool_s_files(
        tmp_path, jax_tools, monkeypatch):
    """Every file byte for byte (JPEGs included), at 40 train and 6 held-out
    images, 2 shots, two seeds."""
    jax_gen = jax_tools("_make_generalization_coco")
    argv = ["--train", "40", "--val", "6", "--shots", "2", "--seed", "0",
            "1"]
    monkeypatch.setattr(sys, "argv", ["x", "--root", str(tmp_path / "jax"),
                                      *argv])
    jax_gen.main()
    port_gen_coco.main(["--root", str(tmp_path / "port"), *argv])
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port")
    assert len([n for n in names if n.endswith(".jpg")]) == 46
    # 80 k-shot files a seed, the two datasplit files
    assert len([n for n in names if n.endswith(".json")]) == 2 * 80 + 2
    for rel in names:
        assert ((tmp_path / "jax" / rel).read_bytes()
                == (tmp_path / "port" / rel).read_bytes()), rel
    with pytest.raises(ValueError, match="too few train images"):
        port_gen_coco.make_generalization_coco(str(tmp_path / "short"),
                                               train=20, val=1)


@pytest.fixture(scope="module")
def small_voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    port_gen_voc.make_generalization_voc(str(root), train_2007=20,
                                         train_2012=10, val=2, shots=(1,))
    return str(root)


def test_collect_crops_equals_the_jax_tool_s(small_voc, jax_tools):
    jax_pcb = jax_tools("train_pcb_extractor")
    want = jax_pcb.collect_crops(small_voc, 32, limit_per_class=3)
    got = port_pcb.collect_crops(small_voc, 32, limit_per_class=3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int32 and got[2] == want[2]
    assert got[0].shape[1:] == (32, 32, 3) and len(set(got[1])) > 10


def _paired_numbers(out):
    """The four AP50s the stats leg pairs: base, ft bAP50, control nAP50,
    ft nAP50."""
    m1 = re.search(r"paired stats: base AP50 (\S+) -> ft bAP50 (\S+) ", out)
    m2 = re.search(r"paired stats: control nAP50 (\S+) -> ft nAP50 (\S+) ",
                   out)
    assert m1 and m2, out[-3000:]
    return [float(v) for v in (*m1.groups(), *m2.groups())]


def test_check_generalization_plumbing_on_the_cpu(tmp_path):
    """A plumbing run, not the gate: base, control, ft and stats through the
    port's CLI and tools at 4 iterations and 10 held-out images, with the
    floors and margins opened through the script's own overrides
    (BASE_AP50_FLOOR 0, NOVEL_AP50_FLOOR 0, BASE_AFTER_FT_FLOOR 0,
    DROP_MARGIN 100, NOVEL_GAIN_MARGIN -100), because 4 iterations learn
    nothing. ``test_torch_generalization_gate.py`` runs the gate with the
    JAX package's floors. The script's CLI processes run with one intra-op
    thread each, as ``test_torch_multiprocess_cli``'s ranks do. Each CLI process appends its kernel launches to
    FSODTF_LAUNCH_COUNTS at exit: none on the CPU, which runs the plain
    versions."""
    env = dict(os.environ, DEVICE="cpu", GEN_LEGS="base,control,ft,stats",
               ITERS_BASE="4", ITERS_FT="4", GEN_VAL="10",
               BASE_AP50_FLOOR="0",
               NOVEL_AP50_FLOOR="0", BASE_AFTER_FT_FLOOR="0",
               DROP_MARGIN="100", NOVEL_GAIN_MARGIN="-100",
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1",
               FSODTF_LAUNCH_COUNTS=str(tmp_path / "launches.jsonl"))
    save = tmp_path / "gen"
    r = subprocess.run(
        ["bash", f"{PORT}/tools/check_generalization.sh", str(save)],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600)
    out = r.stdout
    assert r.returncode == 0, (out + r.stderr)[-6000:]
    for banner in ("=== base training", "=== checkpoint surgery",
                   "=== control:", "=== gfsod 10-shot fine-tune",
                   "=== paired statistics", "PAIRED STATS OK",
                   "GENERALIZATION GATE PASSED (legs: base,control,ft,"
                   "stats)"):
        assert banner in out, banner
    nums = _paired_numbers(out)
    assert len(nums) == 4 and all(0.0 <= v <= 100.0 for v in nums)
    assert (save / "base1" / "model_reset_surgery.pth").is_file()
    assert (save / "10shot_seed0" / "model_final.pth").is_file()
    res = json.load(open(save / "10shot_seed0" /
                         "coco_instances_results.json"))
    assert isinstance(res, list)
    assert not list(save.rglob("*.ckpt"))
    runs = [json.loads(ln) for ln in
            (tmp_path / "launches.jsonl").read_text().splitlines()]
    assert [r["argv"][1].endswith(cfg) for r, cfg in zip(runs, (
        "defrcn_det_r101_base1.yaml", "10shot_seed0.yaml",
        "10shot_seed0.yaml"))] == [True] * 3
    assert "--eval-only" in runs[1]["argv"]
    assert all(r[k] == 0 for r in runs for k in (
        "greedy_nms", "roi_align_v2_fwd", "roi_align_v2_bwd"))
