#!/usr/bin/env bash
# Few-shot workflow, COCO, on the PyTorch package: base train (60 classes)
# -> randinit surgery (60 -> 80) -> per-(seed, shot) gfsod fine-tune ->
# aggregate. A copy of the repository's run_coco.sh (reference run_coco.sh)
# with its arguments, variables, loops, configs and --opts, through this
# package's CLI and surgery; checkpoints are .pth. Like it, it reads
# configs/ and tools/ and writes outputs/ under the working directory.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/run_coco.sh [EXP_NAME]
#
# It runs on the card (MODEL.DEVICE cuda) unless DEVICE=cpu.
set -e

PORT=fewshotobjectdetection_imporove_via_text_feature_torch
DEVICE=${DEVICE:-cuda}
# the package, from any working directory
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:${PYTHONPATH}}"

EXP_NAME=${1:-coco_defrcn}
SAVE_DIR=outputs/${EXP_NAME}
IMAGENET_PRETRAIN=${IMAGENET_PRETRAIN:-weights/R-101.pkl}

python -m ${PORT}.cli --config-file configs/coco/defrcn_det_r101_base.yaml \
    --opts MODEL.WEIGHTS ${IMAGENET_PRETRAIN} \
           OUTPUT_DIR ${SAVE_DIR}/defrcn_det_r101_base \
           MODEL.DEVICE ${DEVICE}

python -m ${PORT}.tools.model_surgery --dataset coco --method randinit \
    --src-path ${SAVE_DIR}/defrcn_det_r101_base/model_final.pth \
    --save-dir ${SAVE_DIR}/defrcn_det_r101_base
BASE_WEIGHT=${SAVE_DIR}/defrcn_det_r101_base/model_reset_surgery.pth

for seed in 0 1 2 3 4 5 6 7 8 9; do
    for shot in 1 2 3 5 10 30; do
        python tools/create_config.py --dataset coco14 --config_root configs/coco \
            --shot ${shot} --seed ${seed} --setting gfsod
        CONFIG_PATH=configs/coco/defrcn_gfsod_r101_novel_${shot}shot_seed${seed}.yaml
        OUTPUT_DIR=${SAVE_DIR}/defrcn_gfsod_r101_novel/tfa-like/${shot}shot_seed${seed}
        python -m ${PORT}.cli --config-file ${CONFIG_PATH} \
            --opts MODEL.WEIGHTS ${BASE_WEIGHT} OUTPUT_DIR ${OUTPUT_DIR} \
                   TEST.PCB_MODELPATH ${PCB_PATH:-weights/resnet101-torchvision.pth} \
                   MODEL.DEVICE ${DEVICE}
        rm ${CONFIG_PATH}
    done
done

python tools/extract_results.py \
    --res-dir ${SAVE_DIR}/defrcn_gfsod_r101_novel/tfa-like \
    --shot-list 1 2 3 5 10 30
