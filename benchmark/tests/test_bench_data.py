"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric dropped into a copy of the benchmark are found by their
names, with no file of the harness edited; the inputs and weights follow
the seed; and with no card a run fails instead of falling back to the
CPU."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from harness import core, infer, port, train
from harness.weights import draw_state
from tiny import tiny_infer_cell, tiny_train_cell

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "defrcn_r101_c4_voc.json").read_text())
    cfg["name"] = "new_config"
    (b / "configs" / "new_config.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "infer_b32.json").read_text())
    mix["batch"] = 16
    (b / "traffic" / "new_mix.json").write_text(json.dumps(mix))
    (b / "metrics" / "new_metric.infer.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    spec["configs"].append({"name": "new_config", "source": "x",
                            "file": "benchmark/configs/new_config.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "new.cell", "config": "new_config",
                              "traffic": "new_mix", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "new_metric.infer", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "infer_images_per_s",
                              "workloads": ["new.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = core.find_cell(core.load_spec(tmp_path), "new.cell", bench=b)
    assert cell["config"]["name"] == "new_config"
    assert cell["traffic"]["batch"] == 16
    assert [m["name"] for m in cell["per_layer"]] == ["new_metric.infer"]
    assert core.load_reader("new_metric.infer", bench=b)({}) == 42.0
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in b.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


def _pool_images(seed):
    cell = tiny_infer_cell()
    cfg = port.build_cfg(cell["config"], "unused")
    pool = infer.make_pool(cell["traffic"], cfg, seed, torch.device("cpu"))
    return [b[0][0].image for b in pool], sorted(b[1] for b in pool)


def test_the_same_seed_makes_the_same_inputs_and_another_seed_others():
    a, ka = _pool_images(2**31 + 100)
    b, kb = _pool_images(2**31 + 100)
    c, kc = _pool_images(7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert ka == kb == kc            # the same sizes for every seed


def test_the_training_batches_follow_the_seed():
    cell = tiny_train_cell()
    cfg = port.build_cfg(cell["config"], "unused", ["SEED", "1"])

    def batches(seed):
        return train.make_batches(cell["traffic"], cfg, seed,
                                  torch.device("cpu"))

    a, b, c = batches(2**31 + 3), batches(2**31 + 3), batches(12)
    for (x, _), (y, _) in zip(a, b):
        assert torch.equal(x[0].image, y[0].image)
        assert torch.equal(x[1].boxes, y[1].boxes)
    assert not all(torch.equal(x[0].image, y[0].image)
                   for (x, _), (y, _) in zip(a, c))
    assert sorted(k for _, k in a) == sorted(k for _, k in c)


def test_the_weights_follow_the_seed():
    rules = [("\\.weight$", {"kind": "he", "gain": 1.0}),
             ("\\.bias$", {"kind": "const", "value": 0.0})]
    shapes = {"a.weight": (8, 4, 3, 3), "a.bias": (8,)}
    w1 = draw_state(shapes, rules, 2**31 + 9, "cpu")
    w2 = draw_state(shapes, rules, 2**31 + 9, "cpu")
    w3 = draw_state(shapes, rules, 10, "cpu")
    assert torch.equal(w1["a.weight"], w2["a.weight"])
    assert not torch.equal(w1["a.weight"], w3["a.weight"])


def _run(cwd, extra_env=None):
    env = dict(os.environ, **(extra_env or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "voc_r101.infer_b32", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_without_a_card_a_run_fails_and_prints_no_result():
    out = _run(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
