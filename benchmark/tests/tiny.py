"""A cell of the benchmark cut to a size the CPU runs in seconds: the
same configuration and traffic files, with the widths, depth, canvas and
proposal counts made small through the configuration's run options."""

from __future__ import annotations

import copy
import types

from harness import core

TINY_OPTS = [
    "MODEL.DEVICE", "cpu", "MODEL.RESNETS.DEPTH", "14",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "4",
    "INPUT.MIN_SIZE_TEST", "128", "INPUT.MAX_SIZE_TEST", "224",
    "TPU.IMAGE_BUCKETS", "((128, 192),)",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "600",
    "MODEL.RPN.POST_NMS_TOPK_TEST", "100",
]


def tiny_infer_cell(name="voc_r101.infer_b32"):
    cell = copy.deepcopy(core.find_cell(core.load_spec(pending=True), name))
    cell["config"]["run_opts"] = cell["config"]["run_opts"] + TINY_OPTS
    t = cell["traffic"]
    t["images"] = [{"width": 100, "height": 75, "count": 4},
                   {"width": 75, "height": 100, "count": 4}]
    t["batch"] = 2
    t["trace_batches"] = 2
    return cell


def args(seed=2**31 + 11, seconds=1.0, trace=0):
    return types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)


# full depth at tiny widths: the fp8 control's training readings separate
# from bfloat16's only with the published depth
TINY_TRAIN_OPTS = [
    "MODEL.DEVICE", "cpu", "MODEL.RESNETS.DEPTH", "101",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "4",
    "TPU.IMAGE_BUCKETS", "((96, 128), (128, 160))",
    "INPUT.MAX_SIZE_TRAIN", "160",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "600",
    "MODEL.RPN.POST_NMS_TOPK_TRAIN", "100",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
    "SOLVER.IMS_PER_BATCH", "2",
]


def tiny_train_cell(name="voc_r101_text_student.train_b16", dtype=None):
    cell = copy.deepcopy(core.find_cell(core.load_spec(pending=True), name))
    c = cell["config"]
    c["run_opts"] = c["run_opts"] + TINY_TRAIN_OPTS
    if dtype:
        c["compute_dtype"] = dtype
    t = cell["traffic"]
    t["batch"] = 2
    t["pool"] = [{"width": 100, "height": 75, "count": 4},
                 {"width": 75, "height": 100, "count": 2}]
    t["batches"] = [
        {"orientation": "landscape", "short_sides": [80, 96], "count": 2},
        {"orientation": "portrait", "short_sides": [80, 96], "count": 1},
        {"orientation": "landscape", "short_sides": [112, 128], "count": 1},
    ]
    t["trace_steps"] = 1
    return cell
