"""Time earlier versions of the port's CUDA kernels in turns with the
current ones, on one card, at ``chip_smoke.py``'s phase 3 and 4 inputs
(NMS, ROIAlign forward) and phase 7 inputs (ROIAlign backward).

    mkdir -p _archive/earlier
    for f in nms roi_align; do
      git show 836942b:fewshotobjectdetection_imporove_via_text_feature_torch/csrc/$f.cu \
        > _archive/earlier/$f.cu
    done
    git show 9d59024:fewshotobjectdetection_imporove_via_text_feature_torch/csrc/roi_align.cu \
      > _archive/earlier_bwd.cu
    python3 -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.compare_kernels \
        [_archive/earlier] [--bwd _archive/earlier_bwd.cu] [--out FILE]

The directory's sources must have the C interface of the first port slice
(commit 836942b): ``fsod_nms_sorted`` takes a (B, N, ceil(N/64)) int64 mask
as scratch, and ``fsod_roi_align_fwd`` the arguments it takes now. The
``--bwd`` source must have the C interface of commit 9d59024:
``fsod_roi_align_bwd`` zeroes a float32 (B, H, W, C) buffer and sums into
it with atomics, and its wrapper here rounds that buffer to grad_out's
dtype, as the wrapper of that commit did. Each is built with this
package's nvcc flags into ``build/torch_kernels/earlier/``.

Every case holds both versions to the plain version (NMS keep masks equal,
ROIAlign forward and backward within chip_smoke's tolerances), then times
them in turns:
earlier, current, current, earlier. Each turn is timed both ways
chip_smoke times a kernel: calls enqueued from Python (``ms``) and the
replay of one call captured in a CUDA graph (``graph_ms``); each reported
time is the mean of its two turns. Prints a line a case and, as the last
line, a JSON object of every case's times (also written to FILE).
"""

from __future__ import annotations

import argparse
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
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (data, dtype, boxes, out, b, h, w, c, s, p, bin_stride, scale, sampling,
#  stream): the forward's, and the earlier backward's
ROI_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_void_p,
]


def _build(src: Path, tag: str) -> ctypes.CDLL:
    out = OUT_DIR / f"libearlier_{tag}.so"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build.nvcc_path(), *cuda_build.FLAGS, "-o", str(out),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


class Earlier:
    """The earlier kernels behind wrappers shaped like the current ones."""

    def __init__(self, src_dir: Path):
        self._nms = _build(src_dir / "nms.cu", "nms").fsod_nms_sorted
        self._nms.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        self._roi = _build(src_dir / "roi_align.cu",
                           "roi_align").fsod_roi_align_fwd
        self._roi.argtypes = ROI_ARGTYPES

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
        cuda_build.check(self._roi(
            nhwc.data_ptr(), _DTYPES[feat.dtype], boxes.data_ptr(),
            out.data_ptr(), b, h,
            w, c, s, p, stride, float(scale), sampling,
            torch.cuda.current_stream().cuda_stream), "earlier roi_align")
        return out.permute(0, 1, 4, 2, 3)


class EarlierBwd:
    """An earlier ROIAlign backward kernel with the float32-buffer C
    interface, behind a wrapper shaped like ``roi_align_bwd_cuda``."""

    def __init__(self, src: Path):
        self._bwd = _build(src, "roi_align_bwd").fsod_roi_align_bwd
        self._bwd.argtypes = ROI_ARGTYPES

    def roi_align_bwd(self, grad_out, boxes, shape, p, scale, sampling,
                      stride):
        b, c, h, w = shape
        g = grad_out.permute(0, 1, 3, 4, 2).contiguous()
        grad32 = torch.empty((b, h, w, c), dtype=torch.float32,
                             device=grad_out.device)
        cuda_build.check(self._bwd(
            g.data_ptr(), _DTYPES[grad_out.dtype], boxes.data_ptr(),
            grad32.data_ptr(), b, h, w, c, boxes.shape[1], p, stride,
            float(scale), sampling, torch.cuda.current_stream().cuda_stream),
            "earlier roi_align_bwd")
        return grad32.to(grad_out.dtype).permute(0, 3, 1, 2)


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


def _plain_grad(args):
    """The autograd of the plain ROIAlign for phase 7's ``args``."""
    from ..ops.roi_align import roi_align_plain

    g, boxes, shape, p, scale, sampling, stride = args
    feat = torch.zeros(shape, dtype=g.dtype, device=g.device,
                       requires_grad=True)
    out = roi_align_plain(feat, boxes, p, scale, sampling, stride)
    return torch.autograd.grad(out, feat, g)[0].float()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(prog="compare_kernels")
    parser.add_argument("earlier", nargs="?", type=Path,
                        help="directory of the earlier nms.cu, roi_align.cu")
    parser.add_argument("--bwd", type=Path,
                        help="the earlier roi_align.cu with the backward")
    parser.add_argument("--out", type=Path)
    opts = parser.parse_args(argv)
    if opts.earlier is None and opts.bwd is None:
        parser.error("give the earlier directory, --bwd, or both")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from ..ops.nms import nms_sorted_plain
    from ..ops.roi_align import roi_align_plain
    from ..ops.roi_align_cuda import roi_align_bwd_cuda

    earlier = Earlier(opts.earlier.resolve()) if opts.earlier else None
    earlier_bwd = EarlierBwd(opts.bwd.resolve()) if opts.bwd else None
    cuda_build.build_all()
    gen = torch.Generator().manual_seed(0)  # chip_smoke's inputs, in order
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"card": smoke.card_line(), "nms": {}, "roi_align": {},
              "roi_align_bwd": {}}
    for name, boxes, valid, thr, mk in smoke.nms_inputs(gen):
        if earlier is None:
            continue
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
        if earlier is None:
            continue
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
    for key, args in (smoke.roi_bwd_inputs(gen) if earlier_bwd else ()):
        ref = _plain_grad(args)
        atol = smoke.ROI_BWD_F32_ATOL * float(ref.abs().max())
        rtol = smoke.ROI_BWD_BF16_RTOL if args[0].dtype == torch.bfloat16 \
            else 0.0
        for who, fn in (("earlier", earlier_bwd.roi_align_bwd),
                        ("current", roi_align_bwd_cuda)):
            if not torch.allclose(fn(*args).float(), ref, rtol=rtol,
                                  atol=atol):
                raise RuntimeError(f"roi_align_bwd[{key}]: the {who} kernel "
                                   f"is outside rtol {rtol}, atol {atol}")
        del ref
        t = result["roi_align_bwd"][key] = in_turns(
            smoke, lambda: earlier_bwd.roi_align_bwd(*args),
            lambda: roi_align_bwd_cuda(*args), 10)
        print(f"roi_align_bwd[{key}]: {json.dumps(t)}", flush=True)
    line = json.dumps(result)
    if opts.out:
        opts.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
