#!/usr/bin/env bash
# Multi-scale RPN distillation with the semantic cross-output head, on the
# PyTorch package. A copy of the repository's run_voc_distillate_rpn.sh
# (reference run_voc_distillate_rpn.sh:12-27) with its arguments,
# variables, configs and --opts, through this package's CLI; checkpoints
# are .pth. Like it, it reads configs/ and writes outputs/ under the
# working directory.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/run_voc_distillate_rpn.sh [EXP_NAME] [SPLIT_ID]
#
# It runs on the card (MODEL.DEVICE cuda) unless DEVICE=cpu.
set -e

PORT=fewshotobjectdetection_imporove_via_text_feature_torch
DEVICE=${DEVICE:-cuda}
# the package, from any working directory
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:${PYTHONPATH}}"

EXP_NAME=${1:-distillate_rpn}
SPLIT_ID=${2:-1}
SAVE_DIR=outputs/${EXP_NAME}
IMAGENET_PRETRAIN=${IMAGENET_PRETRAIN:-weights/R-101.pkl}

cfg_MODEL="
MODEL.META_ARCHITECTURE GeneralizedDistillatedRCNN
MODEL.ROI_HEADS.NAME SematicRes5ROIHeadsCrossOutput
MODEL.ROI_HEADS.OUTPUT_LAYER FastRCNNAttentionOutputLayers
MODEL.ADDITION.NAME glove
"

python -m ${PORT}.cli --config-file configs/voc/defrcn_det_r101_base${SPLIT_ID}.yaml \
    --opts MODEL.WEIGHTS ${IMAGENET_PRETRAIN} \
           OUTPUT_DIR ${SAVE_DIR}/defrcn_det_r101_base${SPLIT_ID} ${cfg_MODEL} \
           MODEL.DEVICE ${DEVICE}
