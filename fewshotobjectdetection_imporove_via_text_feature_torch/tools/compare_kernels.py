"""Time an earlier version of the port's two CUDA kernels in turns with the
current one, on one card, at ``chip_smoke.py``'s phase 3 and 4 inputs.

    mkdir -p _archive/earlier
    for f in nms roi_align; do
      git show 836942b:fewshotobjectdetection_imporove_via_text_feature_torch/csrc/$f.cu \
        > _archive/earlier/$f.cu
    done
    python3 -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.compare_kernels \
        _archive/earlier [--out FILE]

The earlier sources must have the C interface of the first port slice
(commit 836942b): ``fsod_nms_sorted`` takes a (B, N, ceil(N/64)) int64 mask
as scratch, and ``fsod_roi_align_fwd`` the arguments it takes now. They are
built with this package's nvcc flags into ``build/torch_kernels/earlier/``.

Every case holds both versions to the plain version (NMS keep masks equal,
ROIAlign within chip_smoke's tolerances), then times them in turns:
earlier, current, current, earlier. Each turn is timed both ways
chip_smoke times a kernel: calls enqueued from Python (``ms``) and the
replay of one call captured in a CUDA graph (``graph_ms``); each reported
time is the mean of its two turns. Prints a line a case and, as the last
line, a JSON object of every case's times (also written to FILE).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import cuda_build
from ..ops.nms_cuda import nms_sorted_cuda
from ..ops.roi_align_cuda import roi_align_cuda

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = cuda_build.BUILD_DIR / "earlier"


def _build(src_dir: Path, name: str) -> ctypes.CDLL:
    out = OUT_DIR / f"libearlier_{name}.so"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build.nvcc_path(), *cuda_build.FLAGS, "-o", str(out),
           str(src_dir / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


class Earlier:
    """The earlier kernels behind wrappers shaped like the current ones."""

    def __init__(self, src_dir: Path):
        self._nms = _build(src_dir, "nms").fsod_nms_sorted
        self._nms.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        self._roi = _build(src_dir, "roi_align").fsod_roi_align_fwd
        self._roi.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]

    def nms(self, boxes, valid, thresh, max_keep):
        b, n = valid.shape
        keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
        mask = torch.empty((b, n, -(-n // 64)), dtype=torch.int64,
                           device=boxes.device)
        cuda_build.check(self._nms(
            boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(),
            keep.data_ptr(), b, n, float(thresh),
            -1 if max_keep is None else int(max_keep),
            torch.cuda.current_stream().cuda_stream), "earlier nms")
        return keep

    def roi_align(self, feat, boxes, p, scale, sampling, stride):
        b, c, h, w = feat.shape
        s = boxes.shape[1]
        nhwc = feat.permute(0, 2, 3, 1).contiguous()
        p_out = len(range(0, p, stride))
        out = torch.empty((b, s, p_out, p_out, c), dtype=feat.dtype,
                          device=feat.device)
        dtype = {torch.float32: 0, torch.bfloat16: 1}[feat.dtype]
        cuda_build.check(self._roi(
            nhwc.data_ptr(), dtype, boxes.data_ptr(), out.data_ptr(), b, h,
            w, c, s, p, stride, float(scale), sampling,
            torch.cuda.current_stream().cuda_stream), "earlier roi_align")
        return out.permute(0, 1, 4, 2, 3)


def in_turns(smoke, earlier_fn, current_fn, reps):
    """{"earlier"|"current": {"ms", "graph_ms"}}, timed earlier, current,
    current, earlier; each time the mean of its two turns."""
    times = {"earlier": [], "current": []}
    for who, fn in (("earlier", earlier_fn), ("current", current_fn),
                    ("current", current_fn), ("earlier", earlier_fn)):
        times[who].append((smoke.time_ms(fn, reps),
                           smoke.graph_ms(fn, reps)))
    return {who: {"ms": (t[0][0] + t[1][0]) / 2,
                  "graph_ms": (t[0][1] + t[1][1]) / 2}
            for who, t in times.items()}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from ..ops.nms import nms_sorted_plain
    from ..ops.roi_align import roi_align_plain

    earlier = Earlier(Path(argv[0]).resolve())
    cuda_build.build_all()
    gen = torch.Generator().manual_seed(0)  # chip_smoke's inputs, in order
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"card": smoke.card_line(), "nms": {}, "roi_align": {}}
    for name, boxes, valid, thr, mk in smoke.nms_inputs(gen):
        args = (boxes, valid, thr, mk)
        ref = nms_sorted_plain(*args)
        for who, fn in (("earlier", earlier.nms), ("current",
                                                  nms_sorted_cuda)):
            if not torch.equal(fn(*args), ref):
                raise RuntimeError(f"nms[{name}]: the {who} kernel differs")
        t = result["nms"][name] = in_turns(
            smoke, lambda: earlier.nms(*args), lambda: nms_sorted_cuda(*args),
            20)
        print(f"nms[{name}]: {json.dumps(t)}", flush=True)
    for key, args, tol in smoke.roi_inputs(gen):
        ref = roi_align_plain(*args).float()
        for who, fn in (("earlier", earlier.roi_align),
                        ("current", roi_align_cuda)):
            if not torch.allclose(fn(*args).float(), ref, **tol):
                raise RuntimeError(f"roi_align[{key}]: the {who} kernel "
                                   f"is outside {tol}")
        t = result["roi_align"][key] = in_turns(
            smoke, lambda: earlier.roi_align(*args),
            lambda: roi_align_cuda(*args), 10)
        print(f"roi_align[{key}]: {json.dumps(t)}", flush=True)
    line = json.dumps(result)
    if "--out" in argv:
        Path(argv[argv.index("--out") + 1]).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
