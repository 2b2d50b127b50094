#!/usr/bin/env bash
# The few-shot workflow's COCO path on the PyTorch package, step by step as
# tools/smoke_workflow_coco.sh runs it on the JAX package: synthetic COCO
# -> base training (60 classes) from seeded weights -> randinit surgery
# through the COCO id map (60 -> 80 classes, base rows kept) -> per-seed
# config -> gfsod 1-shot fine-tune and COCOEvaluator (all/base/novel) with
# PCB on seeded ResNet weights (TEST.PCB_MODELPATH "") -> extract_results,
# with a tiny detector. The COCO twin of smoke_workflow.sh.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/smoke_workflow_coco.sh [SAVE_DIR] [DEVICE]
#
# It runs on the card (MODEL.DEVICE cuda) unless asked for the CPU: DEVICE
# is the second argument, else $DEVICE, else cuda; pass cpu for the CPU.
# The per-seed config is written into a copy of configs/ under SAVE_DIR;
# nothing is written under configs/.
set -e -o pipefail
cd "$(dirname "$0")/../.."

SAVE_DIR=${1:-${TMPDIR:-/tmp}/smoke_workflow_coco_torch}
DEVICE=${DEVICE:-cuda}
DEVICE=${2:-${DEVICE}}
PORT=fewshotobjectdetection_imporove_via_text_feature_torch
rm -rf "${SAVE_DIR}"
mkdir -p "${SAVE_DIR}"

# synthetic data under its own root: writing into ./datasets would
# overwrite real COCO split files there
DATA_ROOT=${SAVE_DIR}/datasets
export FSODTF_DATASETS=${DATA_ROOT}
python -m ${PORT}.tools.make_synthetic_coco --root "${DATA_ROOT}" --shots 1 --seeds 0

TINY_OPTS="MODEL.DEVICE ${DEVICE}
MODEL.RESNETS.DEPTH 14 MODEL.RESNETS.STEM_OUT_CHANNELS 8
MODEL.RESNETS.RES2_OUT_CHANNELS 16 MODEL.RESNETS.WIDTH_PER_GROUP 4
MODEL.BACKBONE.FREEZE_AT 0
MODEL.RPN.PRE_NMS_TOPK_TRAIN 256 MODEL.RPN.POST_NMS_TOPK_TRAIN 64
MODEL.RPN.PRE_NMS_TOPK_TEST 256 MODEL.RPN.POST_NMS_TOPK_TEST 64
MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE 16
MODEL.ROI_HEADS.SCORE_THRESH_TEST 0.0
TPU.IMAGE_BUCKETS ((256,384),) TPU.MAX_GT 10 TPU.MAX_DETECTIONS_PRE_NMS 128
TPU.COMPUTE_DTYPE float32
INPUT.MIN_SIZE_TRAIN (256,) INPUT.MAX_SIZE_TRAIN 384
INPUT.MIN_SIZE_TEST 256 INPUT.MAX_SIZE_TEST 384
SOLVER.IMS_PER_BATCH 4 SOLVER.BASE_LR 0.001 SOLVER.WARMUP_ITERS 0
SOLVER.CHECKPOINT_PERIOD 0 TEST.EVAL_PERIOD 0 SEED 5"

echo "=== 1. base training (60 classes) ==="
python -m ${PORT}.cli --config-file configs/coco/defrcn_det_r101_base.yaml \
    --opts MODEL.WEIGHTS "" SOLVER.MAX_ITER 5 SOLVER.STEPS "(4,)" \
    OUTPUT_DIR "${SAVE_DIR}/base" ${TINY_OPTS}

echo "=== 2. checkpoint surgery (60 -> 80 classes, COCO id map) ==="
python -m ${PORT}.tools.model_surgery --dataset coco --method randinit \
    --src-path "${SAVE_DIR}/base/model_final.pth" --save-dir "${SAVE_DIR}/base"

echo "=== 3. create per-seed config ==="
cp -r configs "${SAVE_DIR}/configs"
python tools/create_config.py --dataset coco14 --config_root "${SAVE_DIR}/configs/coco" \
    --shot 1 --seed 0 --setting gfsod
CONFIG=${SAVE_DIR}/configs/coco/defrcn_gfsod_r101_novel_1shot_seed0.yaml

echo "=== 4. gfsod fine-tune (80 classes) + PCB eval ==="
OUT=${SAVE_DIR}/1shot_seed0
# PCB on seeded ResNet weights drives the COCO branches the VOC smoke does
# not: the prototypes over COCO-format k-shot dicts and the exclusion of
# the 60 base ids
python -m ${PORT}.cli --config-file "${CONFIG}" \
    --opts MODEL.WEIGHTS "${SAVE_DIR}/base/model_reset_surgery.pth" \
    SOLVER.MAX_ITER 5 SOLVER.STEPS "(4,)" OUTPUT_DIR "${OUT}" \
    TEST.PCB_ENABLE True TEST.PCB_MODELPATH "" ${TINY_OPTS} \
    2>&1 | tee "${OUT}.log"
grep -q "PCB: built 80 class prototypes" "${OUT}.log"
# the CLI writes OUT/log.txt, ending in the copypaste lines
test -f "${OUT}/log.txt"

echo "=== 5. aggregate ==="
python tools/extract_results.py --res-dir "${SAVE_DIR}" --shot-list 1
cat "${SAVE_DIR}/results.txt"
echo "COCO WORKFLOW SMOKE PASSED"
