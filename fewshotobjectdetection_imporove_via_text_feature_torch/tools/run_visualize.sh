#!/usr/bin/env bash
# Evaluate a trained text-teacher checkpoint with PCB, then draw its
# predictions beside the ground truth, on the PyTorch package. A copy of
# the repository's run_visualize.sh (reference run_visualize.sh:25-42, an
# evaluation whose coco_instances_results.json feeds the visualizer) with
# its arguments, variables, configs and --opts, through this package's CLI
# and visualizer; checkpoints are .pth. Like it, it reads configs/ and
# writes outputs/ under the working directory.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/run_visualize.sh [EXP_NAME] [SPLIT_ID]
#
# It runs on the card (MODEL.DEVICE cuda) unless DEVICE=cpu.
set -e

PORT=fewshotobjectdetection_imporove_via_text_feature_torch
DEVICE=${DEVICE:-cuda}
# the package, from any working directory
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:${PYTHONPATH}}"

EXP_NAME=${1:-singleHeadAtt_Text}
SPLIT_ID=${2:-1}
SAVE_DIR=outputs/${EXP_NAME}
PCB_PRETRAIN=${PCB_PRETRAIN:-weights/resnet101-torchvision.pth}
TEACHER_WEIGHTS=${TEACHER_WEIGHTS:-${SAVE_DIR}/teacher_base/defrcn_det_r101_base${SPLIT_ID}/model_final.pth}
TEACHER_PATH=${SAVE_DIR}/teacher_base/defrcn_det_r101_base${SPLIT_ID}

cfg_MODEL="
MODEL.ROI_HEADS.NAME TextRes5ROIHeads
MODEL.ROI_HEADS.TEACHER_TRAINING True
MODEL.ROI_HEADS.STUDENT_TRAINING False
MODEL.ROI_HEADS.DISTILLATE False
"

python -m ${PORT}.cli --eval-only \
    --config-file configs/voc/defrcn_det_r101_base${SPLIT_ID}.yaml \
    --opts MODEL.WEIGHTS ${TEACHER_WEIGHTS} \
           OUTPUT_DIR ${TEACHER_PATH} \
           TEST.PCB_MODELPATH ${PCB_PRETRAIN} ${cfg_MODEL} \
           MODEL.DEVICE ${DEVICE}

# predictions beside the ground truth, from the evaluation's dump
python -m ${PORT}.tools.visualize_json_results \
    --input ${TEACHER_PATH}/coco_instances_results.json \
    --output ${TEACHER_PATH}/visualizations \
    --dataset voc_2007_test_all${SPLIT_ID}
