"""Looks behind the benchmark's readings, on the card; the benchmark's own
runs never call this. Each prints one JSON line a reading.

  python3 benchmark/tools/look.py kernels --workload <cell> --seeds 1,2
      a traced run of the cell for each seed, keeping the ROIAlign calls
      of its untraced pass; then each kept call replayed alone under the
      profiler, back to back (warm L2) and after a 512 MiB read (cold
      L2), beside the trace's kernel time, the least time the run counted
      and the inputs' geometry
  python3 benchmark/tools/look.py witness --workload <training cell>
          --seeds 1,1 [--dtype float32] [--leaf name]
      the training check with every leaf's change gap; with --dtype
      float32 the program runs in float32 with TF32 off everywhere, a
      second witness beside the reference
  python3 benchmark/tools/look.py setup --workload <cell> --seed 1
      the functions that took most of one run's time (cProfile)
  python3 benchmark/tools/look.py steps --workload <training cell>
          --seeds 1 --steps 150 [--variant '[[regex, rule], ...]' ...]
      the training cell's step object stepped on its batches, each
      variant's weight rules put before the configuration's: every
      --every-th step's losses, the valid sampled ROIs and how many are
      empty boxes, and the size of the ROI features and the student
      adapter's output
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import types
from pathlib import Path

import torch

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[2])]

from harness import core, trace, work  # noqa: E402

KEEP = 4          # calls of each operator kept for the replays
REPEATS = 5
KERNELS = {"roi_align": "fsod_roi_align_fwd",
           "roi_align_backward": "fsod_roi_align_bwd"}


def _driver(cell):
    from harness import infer, train

    return train if cell["traffic"]["driver"] == "train" else infer


def _args(seed, seconds, trace_on):
    return types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace_on)


def geometry(op, args) -> dict:
    """What the call's inputs ask of the kernel: box extents on the map,
    samples a bin, the bins that read the map, the bin-tile pairs of the
    backward's 16 x 8 tiles, and the bytes of each count at 3.35 TB/s."""
    if op == "roi_align":
        feat, boxes, p, scale, _, stride = args
        b, c, h, w = feat.shape
        e = feat.element_size()
    else:
        grad, boxes, shape, p, scale, _, stride = args
        b, c, h, w = shape
        e = grad.element_size()
    x = boxes.reshape(-1, 4).float() * scale
    bw, bh = (x[:, 2] - x[:, 0]), (x[:, 3] - x[:, 1])
    gy = torch.ceil(bh / p).clamp(0, max(1, -(-h // p)))
    gx = torch.ceil(bw / p).clamp(0, max(1, -(-w // p)))
    p_out = len(range(0, p, stride))
    ty, tx = work.bin_taps(boxes, h, w, p, stride, scale)
    read = int((ty.any(-1).sum(-1) * tx.any(-1).sum(-1)).sum())

    def tiles(t, n, size):
        pad = -(-n // size) * size - n
        t = torch.nn.functional.pad(t.to(torch.uint8), (0, pad))
        return t.reshape(*t.shape[:2], -1, size).amax(-1).sum(-1)

    bin_tiles = int((tiles(ty, h, 16).sum(1) * tiles(tx, w, 8).sum(1)).sum())
    q = torch.tensor([0.1, 0.5, 0.9], device=x.device)
    out = {"op": op, "map": [b, c, h, w], "rois": int(x.shape[0]),
           "p_out": p_out,
           "box_w_q10_50_90": [round(v, 2) for v in
                               torch.quantile(bw, q).tolist()],
           "box_h_q10_50_90": [round(v, 2) for v in
                               torch.quantile(bh, q).tolist()],
           "empty_rois": int(((bw <= 0) | (bh <= 0)).sum()),
           "samples_a_bin": float((gy * gx).mean()),
           "bins": int(x.shape[0]) * p_out * p_out, "bins_reading": read,
           "bin_tiles": bin_tiles}
    map_bytes = b * c * h * w * e
    if op == "roi_align":
        taps = work.tapped_pixels(boxes, h, w, p, stride, scale)
        out["least_ms"] = 1e3 * work.roi_align_fwd_bytes(
            feat, boxes, p, stride, scale) / work.PEAK_HBM_BYTES
        out["tapped_share"] = taps / (b * h * w)
        # every sample's four taps read from memory, no reuse
        out["sample_reads_ms"] = 1e3 * float((gy * gx).sum()) * p_out ** 2 \
            * 4 * c * e / work.PEAK_HBM_BYTES
    else:
        out["least_ms"] = 1e3 * work.roi_align_bwd_bytes(
            grad, boxes, shape, p, stride, scale) / work.PEAK_HBM_BYTES
        out["every_bin_ms"] = 1e3 * (grad.numel() * e + map_bytes) \
            / work.PEAK_HBM_BYTES
        out["design_ms"] = 1e3 * (bin_tiles * c * e + map_bytes) \
            / work.PEAK_HBM_BYTES
        out["map_write_ms"] = 1e3 * map_bytes / work.PEAK_HBM_BYTES
    return out


def kernels(a, cell, device):
    kept = []

    class Keeping(trace.OpRecorder):
        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types_, args, kwargs)
            name = func.__name__.split(".")[0]
            if func.namespace == "fsod" and name in KERNELS and \
                    sum(k[0] == name for k in kept) < KEEP:
                kept.append((name, func, tuple(
                    x.detach().clone() if isinstance(x, torch.Tensor) else x
                    for x in args)))
            return out

    trace.OpRecorder = Keeping
    flush = torch.zeros(512 << 20, dtype=torch.uint8, device=device)
    for seed in a.seeds:
        kept.clear()
        out = _driver(cell).run(_args(seed, a.seconds, 1), cell, device)
        ctx = out["ctx"]
        t, w = ctx["trace"], ctx["work"]
        for op, frag in KERNELS.items():
            if op not in w:
                continue
            n = sum(v for k, v in t["count"].items() if frag in k)
            print(json.dumps({
                "seed": seed, "op": op, "what": "run",
                "calls_counted": int(w[op]["calls"]),
                "least_ms_a_call": 1e3 * w[op]["least_s"] / w[op]["calls"],
                "trace_launches": n,
                "trace_ms_a_launch":
                    1e3 * trace.kernel_seconds(t, frag) / max(n, 1)}),
                flush=True)
        for i, (op, func, args) in enumerate(kept):
            frag = KERNELS[op]

            def warm():
                for _ in range(REPEATS):
                    func(*args)

            def cold():
                for _ in range(REPEATS):
                    torch.amax(flush)
                    func(*args)

            func(*args)
            rw = trace.profile(warm, device)
            rc = trace.profile(cold, device)
            g = geometry(op, args)
            g.update({"seed": seed, "call": i, "what": "alone",
                      "warm_ms": 1e3 * trace.kernel_seconds(rw, frag)
                      / REPEATS,
                      "cold_ms": 1e3 * trace.kernel_seconds(rc, frag)
                      / REPEATS})
            print(json.dumps(g), flush=True)
        del kept[:]
        torch.cuda.empty_cache()


def witness(a, cell, device):
    from harness import checks_train, train

    if a.dtype:
        cell = copy.deepcopy(cell)
        cell["config"]["compute_dtype"] = a.dtype
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    compare = checks_train.compare
    seed_now = [None]

    def looking(cfg, state, names, ref_out, prog_totals, prog_grad0,
                prog_params):
        values = compare(cfg, state, names, ref_out, prog_totals,
                         prog_grad0, prog_params)
        totals, g0, params = ref_out
        p0 = {n: state[n].float() for n in names}
        g_ref = checks_train._norms(g0)
        med = sorted(g_ref.values())[len(g_ref) // 2]
        keep = [n for n in names if g_ref[n] >= checks_train.NEGLIGIBLE * med]
        d_ref = checks_train._norms({n: params[n] - p0[n] for n in names})
        d_prog = checks_train._norms({n: prog_params[n].float() - p0[n]
                                      for n in names})
        gaps = checks_train._gaps(d_prog, d_ref, keep)
        worst = sorted(gaps, key=gaps.get)[-4:]
        leaves = {n: {"gap": gaps.get(n), "change_prog": d_prog[n],
                      "change_ref": d_ref[n],
                      "norm_before": float(p0[n].norm())}
                  for n in worst + [x for x in a.leaf if x in gaps]}
        print(json.dumps({
            "seed": seed_now[0], "dtype": a.dtype or "configured",
            "loss_prog": [float(v) for v in prog_totals],
            "loss_ref": [float(v) for v in totals],
            "readings": values, "leaves": leaves}), flush=True)
        return values

    checks_train.compare = looking
    for seed in a.seeds:
        seed_now[0] = seed
        out = train.run(_args(seed, a.seconds, 0), cell, device)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "setup_s": out["setup_s"]}), flush=True)


def setup(a, cell, device):
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    _driver(cell).run(_args(a.seeds[0], a.seconds, 0), cell, device)
    prof.disable()
    pstats.Stats(prof).sort_stats("cumulative").print_stats(40)


def steps(a, cell, device):
    import tempfile

    from fewshotobjectdetection_imporove_via_text_feature_torch.engine \
        import Trainer

    from harness import port, train
    from harness.core import sub_seed
    from harness.weights import draw_state

    seed = a.seeds[0]
    for spec in a.variant or [""]:
        config = copy.deepcopy(cell["config"])
        config["weights"] = (json.loads(spec) if spec else []) + \
            config["weights"]
        prog_seed = sub_seed(seed, 4) % (2 ** 31)
        cfg = port.build_cfg(config, tempfile.mkdtemp(prefix="bench_"),
                             ["SEED", str(prog_seed)])
        shapes = port.state_shapes(port.build_model(cfg, "meta"))
        rules = [(p, r) for p, r in config["weights"]]
        state = draw_state(shapes, rules, sub_seed(seed, 1), device)
        bank = draw_state({"class_embed": tuple(
            config["class_embed"]["shape"])}, rules, sub_seed(seed, 5),
            device)["class_embed"]
        trainer = Trainer(cfg, data=[], device=device, state_dict=state)
        model = trainer.model
        with torch.no_grad():
            model.roi_heads.attention.class_embed.copy_(bank)
        batches = train.make_batches(cell["traffic"], cfg, seed, device)
        probe = {}
        hooks = [
            model.roi_heads.register_forward_pre_hook(
                lambda m, x, k: probe.update(boxes=x[1].detach(),
                                             valid=k["valid"].detach()),
                with_kwargs=True),
            model.roi_heads.mlp_adapter.register_forward_hook(
                lambda m, i, o: probe.update(feat=i[0].detach(),
                                             s=o.detach())),
            model.backbone.register_forward_hook(
                lambda m, i, o: probe.update(res4=o["res4"].detach()))]

        def rms(t):
            return float(t.float().pow(2).mean().sqrt())

        it = 0
        for images_, gt, meta, _ in train._cycle_feed(batches, 0, device):
            losses = trainer.train_step(images_, gt, it, meta)
            if it % a.every == 0 or it == a.steps - 1:
                b = probe["boxes"].reshape(-1, 4)
                v = probe["valid"].reshape(-1).bool()
                empty = (b[:, 2] <= b[:, 0]) | (b[:, 3] <= b[:, 1])
                print(json.dumps({
                    "variant": spec, "seed": seed, "step": it,
                    "losses": {n: float(x) for n, x in losses.items()
                               if n.startswith("loss")},
                    "valid_rois": int(v.sum()),
                    "empty_valid_rois": int((empty & v).sum()),
                    "res4_rms": rms(probe["res4"]),
                    "feat_rms": rms(probe["feat"]),
                    "adapter_rms": rms(probe["s"])}), flush=True)
            it += 1
            if it >= a.steps:
                break
        for h in hooks:
            h.remove()
        del trainer, model, state
        torch.cuda.empty_cache()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("what", choices=("kernels", "witness", "setup", "steps"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   type=lambda s: [int(x) for x in s.split(",")])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--dtype", default=None)
    p.add_argument("--leaf", action="append", default=[])
    p.add_argument("--variant", action="append", default=[])
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--every", type=int, default=10)
    a = p.parse_args()
    core.set_cache_dirs()
    core.require_cards(1)
    cell = core.find_cell(core.load_spec(pending=True), a.workload)
    device = torch.device("cuda", 0)
    {"kernels": kernels, "witness": witness, "setup": setup,
     "steps": steps}[a.what](
        a, cell, device)


if __name__ == "__main__":
    main()
