#!/usr/bin/env bash
# Novel fine-tuning with the pure semantic-attention head, per (shot,
# seed), on the PyTorch package. A copy of the repository's
# run_novel_pure_attention.sh (reference run_novel_pure_attention.sh) with
# its arguments, variables, loops, configs and --opts, through this
# package's CLI; checkpoints are .pth. Like it, it reads configs/ and
# tools/ and writes outputs/ under the working directory.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/run_novel_pure_attention.sh [EXP_NAME] [SPLIT_ID]
#
# It runs on the card (MODEL.DEVICE cuda) unless DEVICE=cpu.
set -e

PORT=fewshotobjectdetection_imporove_via_text_feature_torch
DEVICE=${DEVICE:-cuda}
# the package, from any working directory
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:${PYTHONPATH}}"

EXP_NAME=${1:-AttentionRoiHead_CE}
SPLIT_ID=${2:-1}
SAVE_DIR=outputs/${EXP_NAME}
PCB_PRETRAIN=${PCB_PRETRAIN:-weights/resnet101-torchvision.pth}
BASE_WEIGHT=${SAVE_DIR}/teacher_base/defrcn_det_r101_base${SPLIT_ID}/model_reset_surgery.pth

for shot in 1 2 3 5 10; do
    for seed in 0 1 2 3 4 5 6 7 8 9; do
        python tools/create_config.py --dataset voc --config_root configs/voc \
            --shot ${shot} --seed ${seed} --setting gfsod --split ${SPLIT_ID}
        CONFIG_PATH=configs/voc/defrcn_gfsod_r101_novel${SPLIT_ID}_${shot}shot_seed${seed}.yaml
        OUTPUT_DIR=${SAVE_DIR}/teacher_novel${SPLIT_ID}/${shot}shot_seed${seed}
        cfg_MODEL="
        MUTE_HEADER True
        MODEL.ROI_HEADS.NAME SematicRes5ROIHeads
        MODEL.ADDITION.NAME glove
        SOLVER.IMS_PER_BATCH 12
        "
        python -m ${PORT}.cli --config-file ${CONFIG_PATH} \
            --opts MODEL.WEIGHTS ${BASE_WEIGHT} OUTPUT_DIR ${OUTPUT_DIR} \
                   TEST.PCB_MODELPATH ${PCB_PRETRAIN} ${cfg_MODEL} \
                   MODEL.DEVICE ${DEVICE}
        rm ${CONFIG_PATH}
    done
done
