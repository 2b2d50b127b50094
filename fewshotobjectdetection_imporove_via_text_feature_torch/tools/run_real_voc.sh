#!/usr/bin/env bash
# One-command real-data VOC run on the PyTorch package: the preflight gate
# over the data and weights, then base train -> surgery -> k-shot gfsod
# fine-tune with PCB -> results. North-star protocol (BASELINE.md): VOC
# split 1, 10-shot, nAP50. A copy of the repository's tools/run_real_voc.sh
# with its arguments, variables, loops, configs and --opts, through this
# package's preflight, CLI and surgery; checkpoints are .pth. Like it, it
# runs from the repository's root.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/run_real_voc.sh [SPLIT_ID] [SHOT] [SEEDS...]
#
# Without real VOC and weights it stops at the gate with a report of what
# to supply, and starts nothing. It runs on the card (MODEL.DEVICE cuda)
# unless DEVICE=cpu.
set -e -o pipefail  # pipefail: a crashed CLI must not hide behind tee
cd "$(dirname "$0")/../.."

PORT=fewshotobjectdetection_imporove_via_text_feature_torch
DEVICE=${DEVICE:-cuda}

# `shift 2` does nothing (not a partial shift) when $# < 2, which would
# leak SPLIT_ID into SEEDS: shift one argument at a time
SPLIT_ID=${1:-1}
[ $# -ge 1 ] && shift
SHOT=${1:-10}
[ $# -ge 1 ] && shift
SEEDS=${@:-0}
DATA_ROOT=${DATA_ROOT:-datasets}
IMAGENET_PRETRAIN=${IMAGENET_PRETRAIN:-weights/R-101.pkl}
PCB_PRETRAIN=${PCB_PRETRAIN:-weights/resnet101-torchvision.pth}
SAVE_DIR=${SAVE_DIR:-outputs/real_voc}
export FSODTF_DATASETS=${DATA_ROOT}  # the CLI registers datasets from here

# --------------------------- Preflight gate -------------------------------
python -m ${PORT}.tools.preflight_real_voc --root ${DATA_ROOT} \
    --shot ${SHOT} --seeds ${SEEDS} \
    --r101 ${IMAGENET_PRETRAIN} --pcb ${PCB_PRETRAIN}

# --------------------------- Base Pre-train -------------------------------
BASE_DIR=${SAVE_DIR}/defrcn_det_r101_base${SPLIT_ID}
if [ ! -f ${BASE_DIR}/model_final.pth ]; then
    python -m ${PORT}.cli --config-file configs/voc/defrcn_det_r101_base${SPLIT_ID}.yaml \
        --opts MODEL.WEIGHTS ${IMAGENET_PRETRAIN} OUTPUT_DIR ${BASE_DIR} \
               MODEL.DEVICE ${DEVICE}
else
    echo "base checkpoint exists, skipping base train: ${BASE_DIR}"
fi

# --------------------------- Model Surgery --------------------------------
python -m ${PORT}.tools.model_surgery --dataset voc --method randinit \
    --src-path ${BASE_DIR}/model_final.pth \
    --save-dir ${BASE_DIR}
BASE_WEIGHT=${BASE_DIR}/model_reset_surgery.pth

# ----------------------- Novel Fine-tuning (gfsod) ------------------------
for seed in ${SEEDS}; do
    python tools/create_config.py --dataset voc --config_root configs/voc \
        --shot ${SHOT} --seed ${seed} --setting gfsod --split ${SPLIT_ID}
    CONFIG_PATH=configs/voc/defrcn_gfsod_r101_novel${SPLIT_ID}_${SHOT}shot_seed${seed}.yaml
    OUTPUT_DIR=${SAVE_DIR}/defrcn_gfsod_r101_novel${SPLIT_ID}/tfa-like/${SHOT}shot_seed${seed}
    # the CLI writes OUTPUT_DIR/log.txt, whose last "copypaste:" lines
    # extract_results reads
    python -m ${PORT}.cli --config-file ${CONFIG_PATH} \
        --opts MODEL.WEIGHTS ${BASE_WEIGHT} OUTPUT_DIR ${OUTPUT_DIR} \
               TEST.PCB_MODELPATH ${PCB_PRETRAIN} \
               MODEL.DEVICE ${DEVICE}
    rm ${CONFIG_PATH}
done

python tools/extract_results.py \
    --res-dir ${SAVE_DIR}/defrcn_gfsod_r101_novel${SPLIT_ID}/tfa-like \
    --shot-list ${SHOT}
echo "Done. Compare nAP50 against BASELINE.md (DeFRCN VOC split1 ${SHOT}-shot)."
