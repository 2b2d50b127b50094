#!/usr/bin/env bash
# Base-teacher training + student novel distillation, VOC, on the PyTorch
# package. A copy of the repository's run_voc_distillation.sh (reference
# run_voc_distillation.sh:12-63) with its arguments, variables, loops,
# configs and --opts, through this package's CLI and surgery; checkpoints
# are .pth. Like it, it runs every stage in order (the reference exits
# after the base stage), reads configs/ and tools/ and writes outputs/
# under the working directory.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/run_voc_distillation.sh [EXP_NAME] [SPLIT_ID]
#
# It runs on the card (MODEL.DEVICE cuda) unless DEVICE=cpu.
set -e

PORT=fewshotobjectdetection_imporove_via_text_feature_torch
DEVICE=${DEVICE:-cuda}
# the package, from any working directory
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:${PYTHONPATH}}"

EXP_NAME=${1:-att_roi_heads}
SPLIT_ID=${2:-1}
SAVE_DIR=outputs/${EXP_NAME}
IMAGENET_PRETRAIN=${IMAGENET_PRETRAIN:-weights/R-101.pkl}
PCB_PRETRAIN=${PCB_PRETRAIN:-weights/resnet101-torchvision.pth}
BASE_DIR=${SAVE_DIR}/defrcn_det_r101_base${SPLIT_ID}
NOVEL_ROOT=${SAVE_DIR}/defrcn_gfsod_r101_novel${SPLIT_ID}

# ------------------------- Base distillating (teacher) --------------------
cfg_MODEL="MODEL.ROI_HEADS.NAME TextRes5ROIHeads
    MODEL.ADDITION.TEACHER_TRAINING True MODEL.ADDITION.STUDENT_TRAINING False
    MODEL.ADDITION.DISTIL_MODE False MODEL.ADDITION.NAME glove
    SOLVER.IMS_PER_BATCH 8 SOLVER.MAX_ITER 30000"
python -m ${PORT}.cli --config-file configs/voc/defrcn_det_r101_base${SPLIT_ID}.yaml \
    --opts MODEL.WEIGHTS ${IMAGENET_PRETRAIN} OUTPUT_DIR ${BASE_DIR} ${cfg_MODEL} \
           MODEL.DEVICE ${DEVICE}

# ----------------------------- Model Preparation --------------------------
python -m ${PORT}.tools.model_surgery --dataset voc --method randinit \
    --src-path ${BASE_DIR}/model_final.pth --save-dir ${BASE_DIR}
BASE_WEIGHT=${BASE_DIR}/model_reset_surgery.pth

# ------------------------- Novel Fine-tuning (student) --------------------
cfg_STUDENT="MODEL.ROI_HEADS.NAME TextRes5ROIHeads
    MODEL.ROI_HEADS.TEACHER_TRAINING False
    MODEL.ROI_HEADS.STUDENT_TRAINING True MODEL.ROI_HEADS.DISTILLATE False"
for seed in $(seq 0 9); do
    for shot in 1 2 3 5 10; do
        python tools/create_config.py --dataset voc --config_root configs/voc \
            --shot ${shot} --seed ${seed} --setting gfsod --split ${SPLIT_ID}
        CFG=configs/voc/defrcn_gfsod_r101_novel${SPLIT_ID}_${shot}shot_seed${seed}.yaml
        RUN_DIR=${NOVEL_ROOT}/${shot}shot_seed${seed}
        python -m ${PORT}.cli --config-file ${CFG} \
            --opts MODEL.WEIGHTS ${BASE_WEIGHT} OUTPUT_DIR ${RUN_DIR} \
                   TEST.PCB_MODELPATH ${PCB_PRETRAIN} ${cfg_STUDENT} \
                   MODEL.DEVICE ${DEVICE}
        rm ${CFG}
    done
done

python tools/extract_results.py --res-dir ${NOVEL_ROOT} --shot-list 1 2 3 5 10
