#!/usr/bin/env bash
# One-command real-data COCO few-shot run on the PyTorch package: the
# preflight gate over the data and weights, then base train -> surgery ->
# k-shot gfsod fine-tune with PCB -> results. Protocol (BASELINE.md):
# COCO-14, 10/30-shot, nAP. A copy of the repository's
# tools/run_real_coco.sh with its arguments, variables, loops, configs and
# --opts, through this package's preflight, CLI and surgery; checkpoints
# are .pth. Like it, it runs from the repository's root.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/run_real_coco.sh [SHOT] [SEEDS...]
#
# Without real COCO and weights it stops at the gate with a report of what
# to supply, and starts nothing. It runs on the card (MODEL.DEVICE cuda)
# unless DEVICE=cpu.
set -e -o pipefail  # pipefail: a crashed CLI must not hide behind tee
cd "$(dirname "$0")/../.."

PORT=fewshotobjectdetection_imporove_via_text_feature_torch
DEVICE=${DEVICE:-cuda}

SHOT=${1:-10}
[ $# -ge 1 ] && shift
SEEDS=${@:-0}
DATA_ROOT=${DATA_ROOT:-datasets}
IMAGENET_PRETRAIN=${IMAGENET_PRETRAIN:-weights/R-101.pkl}
PCB_PRETRAIN=${PCB_PRETRAIN:-weights/resnet101-torchvision.pth}
SAVE_DIR=${SAVE_DIR:-outputs/real_coco}
export FSODTF_DATASETS=${DATA_ROOT}  # the CLI registers datasets from here

# --------------------------- Preflight gate -------------------------------
python -m ${PORT}.tools.preflight_real_coco --root ${DATA_ROOT} \
    --shot ${SHOT} --seeds ${SEEDS} \
    --r101 ${IMAGENET_PRETRAIN} --pcb ${PCB_PRETRAIN}

# --------------------------- Base Pre-train -------------------------------
# 110k iterations over the 60 base classes (configs/coco/defrcn_det_r101_base.yaml)
BASE_DIR=${SAVE_DIR}/defrcn_det_r101_base
if [ ! -f ${BASE_DIR}/model_final.pth ]; then
    python -m ${PORT}.cli --config-file configs/coco/defrcn_det_r101_base.yaml \
        --opts MODEL.WEIGHTS ${IMAGENET_PRETRAIN} OUTPUT_DIR ${BASE_DIR} \
               MODEL.DEVICE ${DEVICE}
else
    echo "base checkpoint exists, skipping base train: ${BASE_DIR}"
fi

# --------------------------- Model Surgery --------------------------------
# randinit widens the 60-class head to 80 rows, the base rows copied
# through the COCO id map (reference tools/model_surgery.py:70-77)
python -m ${PORT}.tools.model_surgery --dataset coco --method randinit \
    --src-path ${BASE_DIR}/model_final.pth \
    --save-dir ${BASE_DIR}
BASE_WEIGHT=${BASE_DIR}/model_reset_surgery.pth

# ----------------------- Novel Fine-tuning (gfsod) ------------------------
for seed in ${SEEDS}; do
    python tools/create_config.py --dataset coco14 --config_root configs/coco \
        --shot ${SHOT} --seed ${seed} --setting gfsod
    CONFIG_PATH=configs/coco/defrcn_gfsod_r101_novel_${SHOT}shot_seed${seed}.yaml
    OUTPUT_DIR=${SAVE_DIR}/defrcn_gfsod_r101_novel/tfa-like/${SHOT}shot_seed${seed}
    # the CLI writes OUTPUT_DIR/log.txt, whose last "copypaste:" lines
    # extract_results reads
    python -m ${PORT}.cli --config-file ${CONFIG_PATH} \
        --opts MODEL.WEIGHTS ${BASE_WEIGHT} OUTPUT_DIR ${OUTPUT_DIR} \
               TEST.PCB_MODELPATH ${PCB_PRETRAIN} \
               MODEL.DEVICE ${DEVICE}
    rm ${CONFIG_PATH}
done

python tools/extract_results.py \
    --res-dir ${SAVE_DIR}/defrcn_gfsod_r101_novel/tfa-like \
    --shot-list ${SHOT}
echo "Done. Compare nAP against BASELINE.md (DeFRCN COCO ${SHOT}-shot)."
