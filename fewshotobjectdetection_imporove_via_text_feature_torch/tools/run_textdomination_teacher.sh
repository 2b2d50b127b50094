#!/usr/bin/env bash
# Text-domination teacher: evaluate a trained teacher checkpoint, then
# randinit surgery for novel fine-tuning, on the PyTorch package. A copy of
# the repository's run_textdomination_teacher.sh (reference
# run_textdomination_teacher.sh:18-42) with its arguments, variables,
# configs and --opts (the SOLVER keys kept, though --eval-only reads none
# of them), through this package's CLI and surgery; checkpoints are .pth.
# Like it, it runs both stages (the reference exits between them), reads
# configs/ and writes outputs/ under the working directory.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/run_textdomination_teacher.sh [EXP_NAME] [SPLIT_ID]
#
# It runs on the card (MODEL.DEVICE cuda) unless DEVICE=cpu.
set -e

PORT=fewshotobjectdetection_imporove_via_text_feature_torch
DEVICE=${DEVICE:-cuda}
# the package, from any working directory
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:${PYTHONPATH}}"

EXP_NAME=${1:-textDomination}
SPLIT_ID=${2:-1}
SAVE_DIR=outputs/${EXP_NAME}
PCB_PRETRAIN=${PCB_PRETRAIN:-weights/resnet101-torchvision.pth}
# the reference points MODEL.WEIGHTS at an already-trained teacher base
TEACHER_WEIGHTS=${TEACHER_WEIGHTS:-${SAVE_DIR}/teacher_base/defrcn_det_r101_base${SPLIT_ID}/model_final.pth}
TEACHER_PATH=${SAVE_DIR}/teacher_base/defrcn_det_r101_base${SPLIT_ID}

cfg_MODEL="
MODEL.ROI_HEADS.NAME TextRes5ROIHeads_textDomination
MODEL.ROI_HEADS.TEACHER_TRAINING True
MODEL.ROI_HEADS.STUDENT_TRAINING False
MODEL.ROI_HEADS.DISTILLATE False
SOLVER.CHECKPOINT_PERIOD 5000
SOLVER.IMS_PER_BATCH 4
SOLVER.MAX_ITER 60000
"

python -m ${PORT}.cli --eval-only \
    --config-file configs/voc/defrcn_det_r101_base${SPLIT_ID}.yaml \
    --opts MODEL.WEIGHTS ${TEACHER_WEIGHTS} \
           OUTPUT_DIR ${TEACHER_PATH} \
           TEST.PCB_MODELPATH ${PCB_PRETRAIN} ${cfg_MODEL} \
           MODEL.DEVICE ${DEVICE}

python -m ${PORT}.tools.model_surgery --dataset voc --method randinit \
    --src-path ${TEACHER_WEIGHTS} \
    --save-dir ${TEACHER_PATH}
