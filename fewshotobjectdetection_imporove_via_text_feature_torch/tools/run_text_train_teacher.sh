#!/usr/bin/env bash
# Teacher base training with the text-guided attention head, then randinit
# surgery, on the PyTorch package. A copy of the repository's
# run_text_train_teacher.sh (reference run_text_train_teacher.sh) with its
# arguments, variables, configs and --opts, through this package's CLI and
# surgery; checkpoints are .pth. Like it, it reads configs/ and writes
# outputs/ under the working directory.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/run_text_train_teacher.sh [EXP_NAME] [SPLIT_ID]
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
IMAGENET_PRETRAIN=${IMAGENET_PRETRAIN:-weights/R-101.pkl}
PCB_PRETRAIN=${PCB_PRETRAIN:-weights/resnet101-torchvision.pth}
TEACHER_PATH=${SAVE_DIR}/teacher_base/defrcn_det_r101_base${SPLIT_ID}

cfg_MODEL="
MODEL.ROI_HEADS.NAME TextRes5ROIHeads
MODEL.ROI_HEADS.TEACHER_TRAINING True
MODEL.ROI_HEADS.STUDENT_TRAINING False
MODEL.ROI_HEADS.DISTILLATE False
"

python -m ${PORT}.cli --config-file configs/voc/defrcn_det_r101_base${SPLIT_ID}.yaml \
    --opts MODEL.WEIGHTS ${IMAGENET_PRETRAIN} OUTPUT_DIR ${TEACHER_PATH} \
           TEST.PCB_MODELPATH ${PCB_PRETRAIN} ${cfg_MODEL} \
           MODEL.DEVICE ${DEVICE}

python -m ${PORT}.tools.model_surgery --dataset voc --method randinit \
    --src-path ${TEACHER_PATH}/model_final.pth \
    --save-dir ${TEACHER_PATH}
