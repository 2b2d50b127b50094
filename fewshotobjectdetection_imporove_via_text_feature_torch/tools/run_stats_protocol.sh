#!/usr/bin/env bash
# Multi-seed x multi-shot statistical protocol on the PyTorch package: the
# reference's experiment loop end to end at a small scale. A copy of the
# repository's tools/run_stats_protocol.sh with the same knobs, margin and
# banners, over this package's CLI and tools:
#
#   per (shot, seed): create_config -> gfsod fine-tune -> eval ->
#   results/{K}shot_seed{S}/log.txt; then tools/extract_results.py
#   aggregates mean +/- 1.96*sigma/sqrt(n) tables (run_voc.sh:25-44,
#   reference tools/extract_results.py:39-48), and the run asserts the
#   aggregation contract: every per-seed copypaste line scraped, means
#   finite, CI sane.
#
# The same per-seed runs feed a paired multi-seed sabotage A/B of the GDL
# gradient contract (gdl.py:6-38): for each k-shot draw a sabotaged arm
# (BACKWARD_SCALE 1.0 + FREEZE_FEAT False, same training seed) must lose
# held-out strict bAP; the asserted statistic is the mean delta over all
# seeds, robust to the variance of a single draw.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/run_stats_protocol.sh [SAVE_DIR]
#   DEVICE=cpu                 # MODEL.DEVICE (default cuda)
#   STATS_SEEDS="0 1 2"        # k-shot draw seeds (vocsplit/seed{S})
#   STATS_SHOTS="1 10"         # shot counts for the stats table
#   STATS_AB_SHOT=10           # the shot the paired A/B runs at
#   STATS_AB=0                 # 1: also run the sabotaged arms + assert
#   STATS_CACHED_BASE=path     # reuse a surgered base checkpoint (.pth)
#   MEAN_SAB_MARGIN=3          # floor on the MEAN strict-bAP delta
#
# Reference protocol: run_voc.sh:25-44; extract_results.py:39-48.
set -e -o pipefail
cd "$(dirname "$0")/../.."

PORT=fewshotobjectdetection_imporove_via_text_feature_torch
SAVE_DIR=${1:-${TMPDIR:-/tmp}/stats_protocol_torch}
DEVICE=${DEVICE:-cuda}
rm -rf ${SAVE_DIR}
mkdir -p ${SAVE_DIR}

SEEDS=${STATS_SEEDS:-0 1 2}
SHOTS=${STATS_SHOTS:-1 10}
AB_SHOT=${STATS_AB_SHOT:-10}
RUN_AB=${STATS_AB:-0}
MEAN_SAB_MARGIN=${MEAN_SAB_MARGIN:-3}
ITERS_BASE=${ITERS_BASE:-1200}
ITERS_FT=${ITERS_FT:-500}
ITERS_FT_1SHOT=${ITERS_FT_1SHOT:-300}

DATA_ROOT=${SAVE_DIR}/datasets
export FSODTF_DATASETS=${DATA_ROOT}
python -m ${PORT}.tools.make_generalization_voc --root ${DATA_ROOT} \
    --train-2007 120 --train-2012 60 --val 60 \
    --shots ${SHOTS} --seed ${SEEDS}

# check_generalization.sh's tiny production-regularizer profile. SEED is
# the training RNG, held fixed, so the only axis that varies across runs is
# the k-shot draw, the reference protocol's seed dimension (run_voc.sh:26).
TINY_OPTS="MODEL.DEVICE ${DEVICE}
MODEL.RESNETS.DEPTH 14 MODEL.RESNETS.STEM_OUT_CHANNELS 8
MODEL.RESNETS.RES2_OUT_CHANNELS 16 MODEL.RESNETS.WIDTH_PER_GROUP 4
MODEL.BACKBONE.FREEZE_AT 0
MODEL.RPN.PRE_NMS_TOPK_TRAIN 256 MODEL.RPN.POST_NMS_TOPK_TRAIN 64
MODEL.RPN.PRE_NMS_TOPK_TEST 256 MODEL.RPN.POST_NMS_TOPK_TEST 64
MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE 32
TPU.IMAGE_BUCKETS ((288,384),) TPU.MAX_GT 10 TPU.MAX_DETECTIONS_PRE_NMS 128
TPU.COMPUTE_DTYPE float32
INPUT.MIN_SIZE_TRAIN (224,256,288) INPUT.MAX_SIZE_TRAIN 384
INPUT.MIN_SIZE_TEST 288 INPUT.MAX_SIZE_TEST 384
SOLVER.IMS_PER_BATCH 8
SOLVER.CHECKPOINT_PERIOD 0 SEED ${GEN_SEED:-5}"

# ---------------------------------------------------------------- base --
if [ -n "${STATS_CACHED_BASE:-}" ] && [ -f "${STATS_CACHED_BASE}" ]; then
    echo "=== base: using cached surgered checkpoint ==="
    mkdir -p ${SAVE_DIR}/base1
    cp ${STATS_CACHED_BASE} ${SAVE_DIR}/base1/model_reset_surgery.pth
else
    echo "=== base training (shared by every seed) ==="
    python -m ${PORT}.cli --config-file configs/voc/defrcn_det_r101_base1.yaml \
        --opts MODEL.WEIGHTS "" SOLVER.MAX_ITER ${ITERS_BASE} \
        SOLVER.STEPS "($((ITERS_BASE*3/4)),$((ITERS_BASE*9/10)))" \
        SOLVER.BASE_LR 0.01 SOLVER.WARMUP_ITERS 100 \
        OUTPUT_DIR ${SAVE_DIR}/base1 ${TINY_OPTS} \
        2>&1 | tee ${SAVE_DIR}/base1.log
    python -m ${PORT}.tools.model_surgery --dataset voc --method randinit \
        --src-path ${SAVE_DIR}/base1/model_final.pth \
        --save-dir ${SAVE_DIR}/base1
fi
BASE_CKPT=${SAVE_DIR}/base1/model_reset_surgery.pth

CFG_ROOT=${SAVE_DIR}/cfgs
mkdir -p ${CFG_ROOT}/voc
cp configs/Base-RCNN.yaml ${CFG_ROOT}/

# --------------------------------------------- the (shot, seed) loop --
RESULTS=${SAVE_DIR}/results
mkdir -p ${RESULTS}
for shot in ${SHOTS}; do
    iters=${ITERS_FT}
    [ "${shot}" = "1" ] && iters=${ITERS_FT_1SHOT}
    cp configs/voc/defrcn_gfsod_r101_novelx_${shot}shot_seedx.yaml \
       ${CFG_ROOT}/voc/
    for seed in ${SEEDS}; do
        echo "=== gfsod ${shot}-shot seed${seed} fine-tune ==="
        python tools/create_config.py --dataset voc \
            --config_root ${CFG_ROOT}/voc \
            --shot ${shot} --seed ${seed} --setting gfsod --split 1
        CONFIG=${CFG_ROOT}/voc/defrcn_gfsod_r101_novel1_${shot}shot_seed${seed}.yaml
        OUT=${SAVE_DIR}/${shot}shot_seed${seed}
        python -m ${PORT}.cli --config-file ${CONFIG} \
            --opts MODEL.WEIGHTS ${BASE_CKPT} \
            SOLVER.MAX_ITER ${iters} SOLVER.STEPS "($((iters*4/5)),)" \
            SOLVER.BASE_LR 0.01 SOLVER.WARMUP_ITERS 50 \
            TEST.PCB_ENABLE False OUTPUT_DIR ${OUT} ${TINY_OPTS} \
            2>&1 | tee ${OUT}.log
        # reference layout: results/{K}shot_seed{S}/log.txt
        # (run_voc.sh:38-41 cp of the run log)
        mkdir -p ${RESULTS}/${shot}shot_seed${seed}
        cp ${OUT}.log ${RESULTS}/${shot}shot_seed${seed}/log.txt
    done
done

echo "=== aggregate: tools/extract_results.py ==="
python tools/extract_results.py --res-dir ${RESULTS} \
    --shot-list ${SHOTS}
cat ${RESULTS}/results.txt

echo "=== assert the aggregation contract ==="
python - "${RESULTS}" "${SHOTS}" "${SEEDS}" <<'PYEOF'
import math, os, re, sys

res_dir, shots, seeds = sys.argv[1], sys.argv[2].split(), sys.argv[3].split()
table = open(os.path.join(res_dir, "results.txt")).read()
assert table.strip(), "results.txt is empty"
# one "--> K-shot" block per shot (extract_results.py:76; 'u' = mean row,
# 'c' = 1.96*sigma/sqrt(n) row — the reference's labels)
for shot in shots:
    assert f"--> {shot}-shot\n" in table, (
        f"missing {shot}-shot block:\n{table}")
    assert f"--> {shot}-shot: no runs found" not in table
rows = [l for l in table.splitlines() if re.match(r"\|\s*\d+\s*\|", l)]
expect = len(shots) * len(seeds)
assert len(rows) == expect, (
    f"scraped {len(rows)} per-seed rows, expected {expect}:\n{table}")
means = [l for l in table.splitlines() if re.match(r"\|\s*u\s*\|", l)]
cis = [l for l in table.splitlines() if re.match(r"\|\s*c\s*\|", l)]
assert len(means) == len(shots) and len(cis) == len(shots), table
for line in means + cis:
    vals = [float(x) for x in re.findall(r"-?\d+\.\d+", line)]
    assert vals and all(map(math.isfinite, vals)), line
for line in cis:
    vals = [float(x) for x in re.findall(r"-?\d+\.\d+", line)]
    assert all(v >= 0 for v in vals), f"negative CI: {line}"
# the gfsod table carries the bAP/nAP split: 9 metric columns
hdr = [l for l in table.splitlines() if "nAP50" in l]
assert hdr, f"aggregated header lacks the bAP/nAP columns:\n{table}"
print("STATS AGGREGATION OK "
      f"({len(rows)} per-seed rows, {len(means)} mean + {len(cis)} CI rows)")
PYEOF

# --------------------------------------- paired multi-seed sabotage --
if [ "${RUN_AB}" = "1" ]; then
for seed in ${SEEDS}; do
    echo "=== sabotaged arm: ${AB_SHOT}-shot seed${seed} ==="
    CONFIG=${CFG_ROOT}/voc/defrcn_gfsod_r101_novel1_${AB_SHOT}shot_seed${seed}.yaml
    OUT=${SAVE_DIR}/ab_sab_seed${seed}
    python -m ${PORT}.cli --config-file ${CONFIG} \
        --opts MODEL.WEIGHTS ${BASE_CKPT} \
        SOLVER.MAX_ITER ${ITERS_FT} SOLVER.STEPS "($((ITERS_FT*4/5)),)" \
        SOLVER.BASE_LR 0.01 SOLVER.WARMUP_ITERS 50 \
        TEST.PCB_ENABLE False \
        MODEL.RPN.BACKWARD_SCALE 1.0 MODEL.ROI_HEADS.BACKWARD_SCALE 1.0 \
        MODEL.ROI_HEADS.FREEZE_FEAT False \
        OUTPUT_DIR ${OUT} ${TINY_OPTS} 2>&1 | tee ${OUT}.log
done

echo "=== paired multi-seed A/B (mean strict-bAP delta) ==="
python - "${SAVE_DIR}" "${AB_SHOT}" "${SEEDS}" "${MEAN_SAB_MARGIN}" <<'PYEOF'
import sys

save, shot, seeds, margin = (
    sys.argv[1], sys.argv[2], sys.argv[3].split(), float(sys.argv[4]))

def metric(path, idx):
    rows = [l for l in open(path) if "copypaste:" in l and "," in l]
    return float(rows[-1].split("copypaste:")[-1].strip().split(",")[idx])

deltas = []
for s in seeds:
    clean = metric(f"{save}/{shot}shot_seed{s}.log", 3)   # strict bAP
    sab = metric(f"{save}/ab_sab_seed{s}.log", 3)
    deltas.append(clean - sab)
    print(f"seed{s}: clean bAP {clean:.2f}  sabotaged {sab:.2f}  "
          f"delta {clean - sab:.2f}")
mean = sum(deltas) / len(deltas)
print(f"mean strict-bAP delta over {len(deltas)} k-shot draws: "
      f"{mean:.2f} (margin {margin})")
assert mean >= margin, (
    f"PAIRED A/B FAILED: mean delta {mean:.2f} < {margin} — the GDL "
    f"gradient contract no longer measurably protects held-out base AP")
print("PAIRED MULTI-SEED SABOTAGE DETECTED")
PYEOF
fi

echo "STATS PROTOCOL PASSED (shots: ${SHOTS}; seeds: ${SEEDS}; ab: ${RUN_AB})"
