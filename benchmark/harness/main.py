"""One run of one cell: ``python3 benchmark/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``.

The cell's traffic file names its driver (``infer`` or ``train``), which
sets up, warms up, measures the window and checks what it produced; this
module turns that into the result line. With ``--trace 0`` the metrics are
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(each read by ``metrics/<name>.py`` from the traced run), with the
breakdown of the trace beside them.
"""

from __future__ import annotations

import sys

from .core import (
    RunError,
    emit,
    find_cell,
    forbidden_modules,
    load_reader,
    load_spec,
    parse_args,
    require_cards,
    set_cache_dirs,
)


def _driver(name: str):
    if name == "infer":
        from . import infer
        return infer
    if name == "train":
        from . import train
        return train
    raise RunError(f"unknown driver {name!r}")


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        set_cache_dirs()
        spec = load_spec()
        cell = find_cell(spec, args.workload)
        chips = cell["cell"]["chips"]
        require_cards(chips)
        import torch

        device = torch.device("cuda", 0)
        out = _driver(cell["traffic"]["driver"]).run(args, cell, device)
        bad = forbidden_modules()
        if bad:
            raise RunError("modules of JAX or the JAX package were loaded: "
                           + ", ".join(bad))
        metrics = {}
        if args.trace:
            for m in cell["per_layer"]:
                value = load_reader(m["name"])(out["ctx"])
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            for m in cell["end_to_end"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": chips, "memory_peak_bytes": out["peak"]}
        result = {"correct": out["correct"], "attempted": out["attempted"],
                  "failed": out["failed"], "metrics": metrics,
                  "device": device_info}
        if args.trace:
            from .trace import summary

            print(summary(out["ctx"]), file=sys.stderr)
            reading = out["ctx"]["trace"]
            device_info["busy_s"] = reading["busy_s"]
            device_info["window_s"] = reading["window_s"]
            result["breakdown"] = reading["breakdown"]
        print(f"window {out['window_s']:.3f} s, set-up {out['setup_s']:.3f} s,"
              f" check {out['check_s']:.3f} s, peak {out['peak']} bytes",
              file=sys.stderr)
        emit(result, out["checks"])
        return 0
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
