#!/usr/bin/env bash
# Few-shot workflow, VOC, on the PyTorch package: base train -> surgery ->
# per-(shot, seed) gfsod fine-tune -> aggregate. A copy of the
# repository's run_voc.sh (reference run_voc.sh) with its arguments,
# variables, loops, configs and --opts, through this package's CLI and
# surgery; checkpoints are .pth. Like it, it reads configs/ and tools/ and
# writes outputs/ under the working directory.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/run_voc.sh [EXP_NAME] [SPLIT_ID]
#
# It runs on the card (MODEL.DEVICE cuda) unless DEVICE=cpu.
set -e

PORT=fewshotobjectdetection_imporove_via_text_feature_torch
DEVICE=${DEVICE:-cuda}
# the package, from any working directory
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:${PYTHONPATH}}"

EXP_NAME=${1:-voc_defrcn}
SPLIT_ID=${2:-1}
SAVE_DIR=outputs/${EXP_NAME}
IMAGENET_PRETRAIN=${IMAGENET_PRETRAIN:-weights/R-101.pkl}

# ------------------------------- Base Pre-train ---------------------------
python -m ${PORT}.cli --config-file configs/voc/defrcn_det_r101_base${SPLIT_ID}.yaml \
    --opts MODEL.WEIGHTS ${IMAGENET_PRETRAIN} \
           OUTPUT_DIR ${SAVE_DIR}/defrcn_det_r101_base${SPLIT_ID} \
           MODEL.DEVICE ${DEVICE}

# ------------------------------ Model Surgery -----------------------------
python -m ${PORT}.tools.model_surgery --dataset voc --method randinit \
    --src-path ${SAVE_DIR}/defrcn_det_r101_base${SPLIT_ID}/model_final.pth \
    --save-dir ${SAVE_DIR}/defrcn_det_r101_base${SPLIT_ID}
BASE_WEIGHT=${SAVE_DIR}/defrcn_det_r101_base${SPLIT_ID}/model_reset_surgery.pth

# ------------------------- Novel Fine-tuning (gfsod) -----------------------
for seed in 0 1 2 3 4 5 6 7 8 9; do
    for shot in 1 2 3 5 10; do
        python tools/create_config.py --dataset voc --config_root configs/voc \
            --shot ${shot} --seed ${seed} --setting gfsod --split ${SPLIT_ID}
        CONFIG_PATH=configs/voc/defrcn_gfsod_r101_novel${SPLIT_ID}_${shot}shot_seed${seed}.yaml
        OUTPUT_DIR=${SAVE_DIR}/defrcn_gfsod_r101_novel${SPLIT_ID}/tfa-like/${shot}shot_seed${seed}
        python -m ${PORT}.cli --config-file ${CONFIG_PATH} \
            --opts MODEL.WEIGHTS ${BASE_WEIGHT} OUTPUT_DIR ${OUTPUT_DIR} \
                   TEST.PCB_MODELPATH ${PCB_PATH:-weights/resnet101-torchvision.pth} \
                   MODEL.DEVICE ${DEVICE}
        rm ${CONFIG_PATH}
    done
done

python tools/extract_results.py \
    --res-dir ${SAVE_DIR}/defrcn_gfsod_r101_novel${SPLIT_ID}/tfa-like \
    --shot-list 1 2 3 5 10
