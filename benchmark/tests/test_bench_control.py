"""The control of the evaluation cell's check: the float32 reference put in
the program's place and computed in fp8 (e4m3, one scale a tensor, for
both operands of every convolution and linear layer; bfloat16 is the
configuration's precision, fp8 the next below it) must come out not
correct.

As a test it runs at a size a CPU holds. On the card, at the cell's own
size, it reads the control on the seeds it is given (no timed window: the
control's captures of the cell's sampled batches are compared as a run
compares the program's):

    python3 benchmark/tests/test_bench_control.py --workload voc_r101.infer_b32 --seeds 1,2,3

The training cell's control follows its checked steps in fp8 on the
program's own sampled ROIs of each step.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[2])]

import torch  # noqa: E402

from harness import checks_infer, core, infer, port, train  # noqa: E402
from reference.detector import fp8_e4m3  # noqa: E402


def control_readings(cell: dict, seed: int, device) -> dict:
    """The check's numbers with the fp8 reference in the program's place,
    on the batches a run with ``seed`` would check."""
    config, traffic = cell["config"], cell["traffic"]
    cfg = port.build_cfg(config, "unused")
    shapes = port.state_shapes(port.build_model(cfg, "meta"))
    rules = [(p, r) for p, r in config["weights"]]
    from harness.weights import draw_state

    state = draw_state(shapes, rules, core.sub_seed(seed, 1), device)
    pool = infer.make_pool(traffic, cfg, seed, device)
    ref = checks_infer.detector_for(config, cfg, state)
    low = checks_infer.detector_for(config, cfg, state, quant=fp8_e4m3)
    s = checks_infer.settings(cfg)
    values = {n: 0.0 for n in checks_infer.NAMES}
    for i in infer.sampled(pool, traffic["sampled_batches"], seed):
        ib = pool[i][0][0]
        cap = checks_infer.reference_captures(
            low, ib.image.to(device), ib.hw, ib.orig_hw, s)
        got = checks_infer.compare(cap, ref, s)
        values = {n: max(values[n], got[n]) for n in values}
    return values


def train_control_readings(cell: dict, seed: int, device) -> dict:
    """The training check's numbers with the fp8 reference in the
    program's place (on the program's own sampled ROIs of each checked
    step); no timed window."""
    import types

    args = types.SimpleNamespace(seed=seed, seconds=0.0, trace=0)
    out = train.run(args, cell, device, control=fp8_e4m3)
    return {n: c["value"] for n, c in out["checks"].items()}


def readings(cell: dict, seed: int, device) -> dict:
    if cell["traffic"]["driver"] == "train":
        return train_control_readings(cell, seed, device)
    return control_readings(cell, seed, device)


def fails(values: dict, limits: dict) -> list:
    return [n for n in limits if values[n] > limits[n]]


def test_fp8_control_fails_the_evaluation_check():
    from tiny import tiny_infer_cell

    cell = tiny_infer_cell()
    values = control_readings(cell, 2**31 + 5, torch.device("cpu"))
    assert fails(values, cell["traffic"]["limits"]), values


def test_fp8_control_fails_the_training_check():
    from tiny import tiny_train_cell

    cell = tiny_train_cell()
    values = train_control_readings(cell, 2**31 + 5, torch.device("cpu"))
    assert fails(values, cell["traffic"]["limits"]), values


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args()
    core.require_cards(1)
    cell = core.find_cell(core.load_spec(pending=True), a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        values = readings(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"seed": seed, "control": values,
                          "fails": fails(values, cell["traffic"]["limits"])}),
              flush=True)


if __name__ == "__main__":
    main()
