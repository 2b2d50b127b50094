#!/usr/bin/env bash
# Held-out COCO generalization gate on the PyTorch package: the COCO
# few-shot workflow on a learnable synthetic COCO with a disjoint held-out
# val split. A copy of the repository's tools/check_generalization_coco.sh
# with the same legs, floors, margins and banners, over this package's CLI
# and tools.
#
# What it exercises that the VOC gate cannot: COCO's category-id map
# (meta_coco.py), the 60 -> 80 randinit surgery (reference
# tools/model_surgery.py:70-77), the merging of the cocosplit k-shot files,
# and COCO's bAP/nAP on held-out images (reference run_coco.sh:7-44,
# defrcn/evaluation/coco_evaluation.py:132-165).
#
# Legs (GEN_LEGS, comma list; default all):
#   base      60-class base training, held-out AP50 floor (5k.json split)
#   control   the surgered (un-finetuned) base model on coco14_test_all:
#             the novel-AP control of the paired stats
#   ft        gfsod 10-shot fine-tune (production gradient contract),
#             held-out bAP50/nAP50 floors
#   stats     paired invariants: ft bAP50 >= base AP50 - DROP_MARGIN and
#             ft nAP50 >= control nAP50 + NOVEL_GAIN_MARGIN
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/check_generalization_coco.sh [SAVE_DIR]
#   DEVICE=cpu ...                     # MODEL.DEVICE (default cuda)
#   GEN_CACHED_BASE=path.pth ...       # a surgered base checkpoint when
#                                      # the base leg is off
#
# COCO copypaste CSV layout (evaluation/coco_eval.py):
#   base split:  AP,AP50,AP75,APs,APm,APl                      (AP50 = 1)
#   all split:   ... + bAP..bAPl + nAP..nAPl  (bAP50 = 7, nAP50 = 13)
set -e -o pipefail
cd "$(dirname "$0")/../.."

PORT=fewshotobjectdetection_imporove_via_text_feature_torch
SAVE_DIR=${1:-${TMPDIR:-/tmp}/check_generalization_coco_torch}
DEVICE=${DEVICE:-cuda}
rm -rf ${SAVE_DIR}
mkdir -p ${SAVE_DIR}

LEGS=${GEN_LEGS:-base,control,ft,stats}
has() { case ",$LEGS," in *",$1,"*) return 0;; *) return 1;; esac; }
need() { # need <path> <leg> <producer-leg>
    if [ ! -e "$1" ]; then
        echo "ERROR: leg '$2' needs $1 — run the '$3' leg first" \
             "(same SAVE_DIR) or add it to GEN_LEGS" >&2
        exit 1
    fi
}

DATA_ROOT=${SAVE_DIR}/datasets
export FSODTF_DATASETS=${DATA_ROOT}
python -m ${PORT}.tools.make_generalization_coco --root ${DATA_ROOT} \
    --train 192 --val 60 --shots 10 --seed 0

# The floors of tools/check_generalization_coco.sh, unchanged. Its
# calibration (the JAX package, CPU, seed 5): base held-out AP50 98.52;
# control bAP50 98.52 / nAP50 0.00; ft AP50 97.98, bAP50 99.24, nAP50
# 94.20: drop -0.72, novel gain +94.20. The absolute floors leave wide
# seed and draw margin; the paired stats are the tight instruments.
BASE_AP50_FLOOR=${BASE_AP50_FLOOR:-60}
NOVEL_AP50_FLOOR=${NOVEL_AP50_FLOOR:-25}
BASE_AFTER_FT_FLOOR=${BASE_AFTER_FT_FLOOR:-60}
DROP_MARGIN=${DROP_MARGIN:-15}
NOVEL_GAIN_MARGIN=${NOVEL_GAIN_MARGIN:-20}
ITERS_BASE=${ITERS_BASE:-1200}
ITERS_FT=${ITERS_FT:-500}

# the VOC gate's tiny production-regularizer profile
TINY_OPTS="MODEL.DEVICE ${DEVICE}
MODEL.RESNETS.DEPTH 14 MODEL.RESNETS.STEM_OUT_CHANNELS 8
MODEL.RESNETS.RES2_OUT_CHANNELS 16 MODEL.RESNETS.WIDTH_PER_GROUP 4
MODEL.BACKBONE.FREEZE_AT 0
MODEL.RPN.PRE_NMS_TOPK_TRAIN 256 MODEL.RPN.POST_NMS_TOPK_TRAIN 64
MODEL.RPN.PRE_NMS_TOPK_TEST 256 MODEL.RPN.POST_NMS_TOPK_TEST 64
MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE 32
TPU.IMAGE_BUCKETS ((288,384),) TPU.MAX_GT 10 TPU.MAX_DETECTIONS_PRE_NMS 128
TPU.COMPUTE_DTYPE float32
INPUT.MIN_SIZE_TRAIN (224,256,288) INPUT.MAX_SIZE_TRAIN 384
INPUT.MIN_SIZE_TEST 288 INPUT.MAX_SIZE_TEST 384
SOLVER.IMS_PER_BATCH 8
SOLVER.CHECKPOINT_PERIOD 0 SEED ${GEN_SEED:-5}"

metric() { # metric <log> <index>
    python - "$1" "$2" <<'PYEOF'
import sys
rows = [l for l in open(sys.argv[1]) if "copypaste:" in l and "," in l]
vals = rows[-1].split("copypaste:")[-1].strip().split(",")
print(float(vals[int(sys.argv[2])]))
PYEOF
}

# ---------------------------------------------------------------- base --
if has base; then
echo "=== COCO base training (60 classes, held-out eval) ==="
python -m ${PORT}.cli --config-file configs/coco/defrcn_det_r101_base.yaml \
    --opts MODEL.WEIGHTS "" SOLVER.MAX_ITER ${ITERS_BASE} \
    SOLVER.STEPS "($((ITERS_BASE*3/4)),$((ITERS_BASE*9/10)))" \
    SOLVER.BASE_LR 0.01 SOLVER.WARMUP_ITERS 100 \
    TEST.EXPECTED_RESULTS "[('bbox','AP50',100.0,$((100-BASE_AP50_FLOOR)))]" \
    OUTPUT_DIR ${SAVE_DIR}/base ${TINY_OPTS} 2>&1 | tee ${SAVE_DIR}/base.log

echo "=== checkpoint surgery (60 -> 80 classes, COCO IDMAP) ==="
python -m ${PORT}.tools.model_surgery --dataset coco --method randinit \
    --src-path ${SAVE_DIR}/base/model_final.pth --save-dir ${SAVE_DIR}/base
elif has control || has ft; then
CACHED=${GEN_CACHED_BASE:?GEN_CACHED_BASE required when base leg is off}
mkdir -p ${SAVE_DIR}/base
cp ${CACHED} ${SAVE_DIR}/base/model_reset_surgery.pth
fi
BASE_CKPT=${SAVE_DIR}/base/model_reset_surgery.pth

echo "=== create per-seed config ==="
CFG_ROOT=${SAVE_DIR}/cfgs
mkdir -p ${CFG_ROOT}/coco
cp configs/Base-RCNN.yaml ${CFG_ROOT}/
cp configs/coco/defrcn_gfsod_r101_novel_10shot_seedx.yaml ${CFG_ROOT}/coco/
python tools/create_config.py --dataset coco14 --config_root ${CFG_ROOT}/coco \
    --shot 10 --seed 0 --setting gfsod
CONFIG=${CFG_ROOT}/coco/defrcn_gfsod_r101_novel_10shot_seed0.yaml

# PCB off: there are no ImageNet weights; PCB's effect is the VOC gate's
# pcb leg

# ------------------------------------------------------------- control --
if has control; then
echo "=== control: surgered base model on coco14_test_all (no ft) ==="
python -m ${PORT}.cli --config-file ${CONFIG} --eval-only \
    --opts MODEL.WEIGHTS ${BASE_CKPT} TEST.PCB_ENABLE False \
    OUTPUT_DIR ${SAVE_DIR}/control ${TINY_OPTS} \
    2>&1 | tee ${SAVE_DIR}/control.log
fi

# ------------------------------------------------------------------ ft --
if has ft; then
echo "=== COCO gfsod 10-shot fine-tune (production gradient contract) ==="
OUT=${SAVE_DIR}/10shot_seed0
python -m ${PORT}.cli --config-file ${CONFIG} \
    --opts MODEL.WEIGHTS ${BASE_CKPT} \
    SOLVER.MAX_ITER ${ITERS_FT} SOLVER.STEPS "($((ITERS_FT*4/5)),)" \
    SOLVER.BASE_LR 0.01 SOLVER.WARMUP_ITERS 50 OUTPUT_DIR ${OUT} \
    TEST.PCB_ENABLE False \
    TEST.EXPECTED_RESULTS "[('bbox','nAP50',100.0,$((100-NOVEL_AP50_FLOOR))),('bbox','bAP50',100.0,$((100-BASE_AFTER_FT_FLOOR)))]" \
    ${TINY_OPTS} 2>&1 | tee ${OUT}.log
fi

# --------------------------------------------------------------- stats --
if has stats; then
echo "=== paired statistics (COCO leg) ==="
need ${SAVE_DIR}/10shot_seed0.log stats ft
need ${SAVE_DIR}/control.log stats control
if [ -f ${SAVE_DIR}/base.log ]; then
    BASE_AP50=$(metric ${SAVE_DIR}/base.log 1)
else
    BASE_AP50="None"
fi
FT_BAP50=$(metric ${SAVE_DIR}/10shot_seed0.log 7)
FT_NAP50=$(metric ${SAVE_DIR}/10shot_seed0.log 13)
CTRL_NAP50=$(metric ${SAVE_DIR}/control.log 13)
python - <<PYEOF
base, ft_b, ft_n, ctrl_n = ${BASE_AP50}, ${FT_BAP50}, ${FT_NAP50}, ${CTRL_NAP50}
gain = ft_n - ctrl_n
if base is not None:
    drop = base - ft_b
    print(f"paired stats: base AP50 {base:.2f} -> ft bAP50 {ft_b:.2f} "
          f"(drop {drop:.2f}, margin ${DROP_MARGIN})")
    assert drop <= ${DROP_MARGIN}, (
        f"fine-tune lost {drop:.2f} held-out base AP50 vs the base model "
        f"(> ${DROP_MARGIN}): base-class knowledge silently regressed")
print(f"paired stats: control nAP50 {ctrl_n:.2f} -> ft nAP50 {ft_n:.2f} "
      f"(gain {gain:.2f}, margin ${NOVEL_GAIN_MARGIN})")
assert gain >= ${NOVEL_GAIN_MARGIN}, (
    f"fine-tune gained only {gain:.2f} held-out novel AP50 over the "
    f"un-finetuned control (< ${NOVEL_GAIN_MARGIN}): COCO few-shot "
    f"learning silently broken")
print("COCO PAIRED STATS OK")
PYEOF
fi

echo "COCO GENERALIZATION GATE PASSED (legs: ${LEGS})"
