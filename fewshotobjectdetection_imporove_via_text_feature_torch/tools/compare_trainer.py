"""Time ``Trainer.train`` of an earlier checkout of the port in turns with
this checkout's, on one card, on the same batches in host memory:

    mkdir -p _archive/earlier
    git archive 9d59024 | tar -x -C _archive/earlier
    python3 fewshotobjectdetection_imporove_via_text_feature_torch/tools/compare_trainer.py \\
        _archive/earlier

Each turn (earlier, current, current, earlier) is a process of its own that
imports the package from one checkout, builds that checkout's kernels and
runs ``chip_smoke.py``'s phase 8 (b), this checkout's version, on it
(not (c), which would hold an earlier checkout's kernels to this one's
contract): ``Trainer(cfg, batches)`` on
configs/voc/defrcn_det_r101_base1.yaml at full width, bf16, SOLVER.IMS_PER_BATCH 16, over two synthetic 800x1344
batches, 2 warm-up and 10 timed steps, each ended by a CUDA event with no
synchronize between steps. So only the package differs between turns.
Prints each turn's output and, last, a JSON object of each checkout's
median and mean step ms and peak memory (GiB), by turn.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CHILD = """
import importlib.util, json, sys, tempfile
sys.path.insert(0, {checkout!r})
spec = importlib.util.spec_from_file_location("smoke", {smoke!r})
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
smoke.phase_build()
with tempfile.TemporaryDirectory() as tmp:
    per_step, _, _ = smoke.phase_train_bf16(tmp)
print(json.dumps(per_step))
"""


def turn(checkout: Path) -> dict:
    code = CHILD.format(checkout=str(checkout),
                        smoke=str(ROOT / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"turn in {checkout} failed "
                           f"({proc.returncode}):\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(__doc__)
    earlier = Path(argv[0]).resolve()
    times = {"earlier": [], "current": []}
    for name, checkout in (("earlier", earlier), ("current", ROOT),
                           ("current", ROOT), ("earlier", earlier)):
        res = turn(checkout)
        times[name].append({k: res[k] for k in ("median_ms", "window_ms",
                                                 "peak_gib")})
        print(f"turn {name}: median step {res['median_ms']:.2f} ms, mean "
              f"{res['window_ms']:.2f} ms, peak memory "
              f"{res['peak_gib']:.3f} GiB", flush=True)
    print(json.dumps(times))


if __name__ == "__main__":
    main()
