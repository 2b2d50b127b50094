#!/usr/bin/env bash
# Per (shot, seed): teacher novel fine-tune -> reset surgery -> student
# novel distillation, on the PyTorch package. A copy of the repository's
# run_text_train_teacher_novel.sh (reference
# run_text_train_teacher_novel.sh:26-76) with its arguments, variables,
# loops, configs and --opts, through this package's CLI and surgery;
# checkpoints are .pth. Like it, it reads configs/ and tools/ and writes
# outputs/ under the working directory, and keeps its two documented
# departures from the reference: the committed GeneralizedRCNN (the
# reference names a GeneralizedRCNN2 it never committed), and OUTPUT_DIR
# passed beside TEACHER_NOVEL_DIR, so that the teacher's checkpoint lands
# where the next stage reads it.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/run_text_train_teacher_novel.sh [EXP_NAME] [SPLIT_ID]
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
BASE_PATH=${SAVE_DIR}/teacher_base/defrcn_det_r101_base${SPLIT_ID}
BASE_WEIGHT=${BASE_PATH}/model_reset_surgery.pth

for shot in 1 2 3 5 10; do
    for seed in 0 1 2 3 4 5 6 7 8 9; do
        python tools/create_config.py --dataset voc --config_root configs/voc \
            --shot ${shot} --seed ${seed} --setting gfsod --split ${SPLIT_ID}
        CONFIG_PATH=configs/voc/defrcn_gfsod_r101_novel${SPLIT_ID}_${shot}shot_seed${seed}.yaml

        TEACHER_NOVEL_DIR=${SAVE_DIR}/teacher_novel${SPLIT_ID}/${shot}shot_seed${seed}
        NOVEL_WEIGHT=${BASE_WEIGHT}

        # ----------------------- teacher novel fine-tuning ----------------
        cfg_MODEL="
        MUTE_HEADER True
        MODEL.ROI_HEADS.NAME TextRes5ROIHeads
        MODEL.ROI_HEADS.TEACHER_TRAINING True
        MODEL.ROI_HEADS.STUDENT_TRAINING False
        MODEL.ROI_HEADS.DISTILLATE False
        SOLVER.IMS_PER_BATCH 16
        "
        python -m ${PORT}.cli --config-file ${CONFIG_PATH} \
            --opts MODEL.WEIGHTS ${NOVEL_WEIGHT} \
                   TEACHER_NOVEL_DIR ${TEACHER_NOVEL_DIR} \
                   OUTPUT_DIR ${TEACHER_NOVEL_DIR} \
                   TEST.PCB_MODELPATH ${PCB_PRETRAIN} ${cfg_MODEL} \
                   MODEL.DEVICE ${DEVICE}

        python -m ${PORT}.tools.model_surgery --dataset voc --method reset \
            --src-path ${TEACHER_NOVEL_DIR}/model_final.pth \
            --save-dir ${TEACHER_NOVEL_DIR}
        TEACHER_NOVEL_WEIGHT=${TEACHER_NOVEL_DIR}/model_reset_optimizer.pth

        # ---------------------- student novel distillation ----------------
        cfg_MODEL="
        MUTE_HEADER True
        MODEL.ROI_HEADS.NAME TextRes5ROIHeads
        MODEL.ROI_HEADS.TEACHER_TRAINING False
        MODEL.ROI_HEADS.STUDENT_TRAINING True
        MODEL.ROI_HEADS.DISTILLATE True
        MODEL.ROI_HEADS.L2 False
        MODEL.ROI_HEADS.KL_TEMP 5
        SOLVER.IMS_PER_BATCH 16
        "
        STUDENT_DIR=${SAVE_DIR}/student_novel${SPLIT_ID}/${shot}shot_seed${seed}
        python -m ${PORT}.cli --config-file ${CONFIG_PATH} \
            --opts MODEL.WEIGHTS ${NOVEL_WEIGHT} OUTPUT_DIR ${STUDENT_DIR} \
                   TEST.PCB_MODELPATH ${PCB_PRETRAIN} ${cfg_MODEL} \
                   MODEL.DEVICE ${DEVICE}

        rm ${CONFIG_PATH}
    done
done
