#!/usr/bin/env bash
# Held-out generalization gate on the PyTorch package: the few-shot
# workflow on a learnable synthetic VOC with a disjoint held-out val split,
# with the production regularizers on (cls dropout, the GDL BACKWARD_SCALE /
# FREEZE_FEAT contract, multi-scale resize, weight-decay groups). A copy of
# the repository's tools/check_generalization.sh with the same legs, knobs,
# floors, margins and banners, over this package's CLI and tools.
#
# Legs (GEN_LEGS, comma list; default all):
#   base      15-class base training, held-out AP50 floor
#   control   the surgered (un-finetuned) base model on the gfsod test set:
#             the novel-AP control of the paired stats
#   ft        gfsod 10-shot fine-tune, held-out bAP50/nAP50 floors
#   stats     paired invariants: ft bAP50 >= base AP50 - DROP_MARGIN and
#             ft nAP50 >= control nAP50 + NOVEL_GAIN_MARGIN
#   ab        same-seed clean-vs-sabotaged contract A/B: the sabotaged arm
#             (BACKWARD_SCALE 1.0 + FREEZE_FEAT False) must lose
#             >= SAB_MARGIN held-out strict bAP
#   semantic  SematicRes5ROIHeads gfsod fine-tune from the same surgery
#             checkpoint (run_novel_pure_attention.sh:37), held out and
#             not GT-leaky (plain meta-arch, no painting)
#   pcb       PCB's effect: train PCB's own torchvision R-101 on GT crops
#             (train_pcb_extractor), re-evaluate the ft model with
#             TEST.PCB_ENABLE True, and assert PCB-on nAP50 >= PCB-off
#             nAP50 - PCB_EPS on the held-out split, base scores untouched
#   text      GeneralizedTextRCNN teacher-recipe base training
#             (run_text_train_teacher.sh), held out, GT painted at test
#             time (the reference's own protocol)
#   serving   the text model with TEST.NO_GT_EVAL True: the serving path
#             (all-background paint) must still detect on held-out images
#   distill   two-stage teacher -> cold student distillation:
#             reset_student surgery on the text checkpoint, DISTILLATE +
#             L2 + KL training, held-out floor
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/check_generalization.sh [SAVE_DIR]
#   DEVICE=cpu ...                     # MODEL.DEVICE (default cuda)
#   GEN_LEGS=base,ft,stats ...         # subset
#   GEN_SKIP_TEXT=1 ...                # drop text,serving,distill
#   GEN_SABOTAGE=1 ...                 # base,control,ft,ab only
#   GEN_CACHED_BASE=path.pth ...       # reuse a surgered base checkpoint
#   GEN_VAL=60 ...                     # held-out images
#
# Reference protocol: run_voc.sh:25-44;
# defrcn/evaluation/pascal_voc_evaluation.py:131-148.
set -e -o pipefail
cd "$(dirname "$0")/../.."

PORT=fewshotobjectdetection_imporove_via_text_feature_torch
SAVE_DIR=${1:-${TMPDIR:-/tmp}/check_generalization_torch}
DEVICE=${DEVICE:-cuda}
rm -rf ${SAVE_DIR}
mkdir -p ${SAVE_DIR}

LEGS=${GEN_LEGS:-base,control,ft,stats,ab,semantic,pcb,text,serving,distill}
if [ "${GEN_SKIP_TEXT:-0}" = "1" ]; then
    # word-boundary strip on the comma-wrapped list: works at any position
    LEGS=",${LEGS},"
    for _l in text serving distill; do LEGS=${LEGS//,${_l},/,}; done
    LEGS=${LEGS#,}; LEGS=${LEGS%,}
fi
if [ "${GEN_SABOTAGE:-0}" = "1" ]; then
    LEGS="base,control,ft,ab"
fi
if [ -n "${GEN_CACHED_BASE:-}" ] && [ -f "${GEN_CACHED_BASE}" ]; then
    LEGS=",${LEGS},"; LEGS=${LEGS//,base,/,}; LEGS=${LEGS#,}; LEGS=${LEGS%,}
fi
has() { case ",$LEGS," in *",$1,"*) return 0;; *) return 1;; esac; }
# fail fast with a clear message when a leg's input from an earlier leg is
# missing (e.g. GEN_LEGS=stats with no earlier run)
need() { # need <path> <leg> <producer-leg>
    if [ ! -e "$1" ]; then
        echo "ERROR: leg '$2' needs $1 — run the '$3' leg first" \
             "(same SAVE_DIR) or add it to GEN_LEGS" >&2
        exit 1
    fi
}

DATA_ROOT=${SAVE_DIR}/datasets
export FSODTF_DATASETS=${DATA_ROOT}
python -m ${PORT}.tools.make_generalization_voc --root ${DATA_ROOT} \
    --train-2007 120 --train-2012 60 --val ${GEN_VAL:-60} --shots 10 --seed 0

# The floors of tools/check_generalization.sh, unchanged. Its calibration
# (the JAX package, seed 5): base 92.3; ft nAP50 90.9+; sabotage delta
# 3.7; semantic 92.2-93.8; text painted 93.0-93.3; text serving 76.2-86.3;
# distill cold student 93.1-93.3. The absolute floors leave >= 20 points
# for seed, data-draw and platform noise (held-out nAP50 varied 53-100
# across draws); the paired stats and the A/B are the tight instruments.
BASE_AP50_FLOOR=${BASE_AP50_FLOOR:-60}
NOVEL_AP50_FLOOR=${NOVEL_AP50_FLOOR:-30}
BASE_AFTER_FT_FLOOR=${BASE_AFTER_FT_FLOOR:-70}
DROP_MARGIN=${DROP_MARGIN:-12}
NOVEL_GAIN_MARGIN=${NOVEL_GAIN_MARGIN:-20}
# single-seed A/B floor; the tight statistical instrument is the paired
# multi-seed mean delta of run_stats_protocol.sh (STATS_AB=1, margin 3)
SAB_MARGIN=${SAB_MARGIN:-1}
SEM_NOVEL_FLOOR=${SEM_NOVEL_FLOOR:-25}
SEM_BASE_FLOOR=${SEM_BASE_FLOOR:-60}
TEXT_AP50_FLOOR=${TEXT_AP50_FLOOR:-25}
SERVING_AP50_FLOOR=${SERVING_AP50_FLOOR:-25}
DISTILL_AP50_FLOOR=${DISTILL_AP50_FLOOR:-25}
ITERS_BASE=${ITERS_BASE:-1200}
ITERS_FT=${ITERS_FT:-500}
ITERS_TEXT=${ITERS_TEXT:-1200}
ITERS_DISTILL=${ITERS_DISTILL:-1200}

# Tiny model profile: the production regularizers and augmentation at a
# small scale. No dropout/GDL/score-threshold overrides: those come from
# the configs.
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

# copypaste CSV layout: AP,AP50,AP75[,bAP,bAP50,bAP75,nAP,nAP50,nAP75]
metric() { # metric <log> <index>
    python - "$1" "$2" <<'PYEOF'
import sys
rows = [l for l in open(sys.argv[1]) if "copypaste:" in l and "," in l]
vals = rows[-1].split("copypaste:")[-1].strip().split(",")
print(float(vals[int(sys.argv[2])]))
PYEOF
}

# ---------------------------------------------------------------- base --
if has base; then
echo "=== base training (15 base classes, held-out eval) ==="
# lr 0.01 + warmup 100: lr 0.02 at this scale is a convergence coin flip
python -m ${PORT}.cli --config-file configs/voc/defrcn_det_r101_base1.yaml \
    --opts MODEL.WEIGHTS "" SOLVER.MAX_ITER ${ITERS_BASE} \
    SOLVER.STEPS "($((ITERS_BASE*3/4)),$((ITERS_BASE*9/10)))" \
    SOLVER.BASE_LR 0.01 SOLVER.WARMUP_ITERS 100 \
    TEST.EXPECTED_RESULTS "[('bbox','AP50',100.0,$((100-BASE_AP50_FLOOR)))]" \
    OUTPUT_DIR ${SAVE_DIR}/base1 ${TINY_OPTS} 2>&1 | tee ${SAVE_DIR}/base1.log

echo "=== checkpoint surgery (15 -> 20 classes) ==="
python -m ${PORT}.tools.model_surgery --dataset voc --method randinit \
    --src-path ${SAVE_DIR}/base1/model_final.pth --save-dir ${SAVE_DIR}/base1
elif has control || has ft || has ab || has semantic; then
echo "=== base leg skipped: using cached base checkpoint ==="
CACHED=${GEN_CACHED_BASE:?GEN_CACHED_BASE required when base leg is off}
mkdir -p ${SAVE_DIR}/base1
cp ${CACHED} ${SAVE_DIR}/base1/model_reset_surgery.pth
fi
BASE_CKPT=${SAVE_DIR}/base1/model_reset_surgery.pth

echo "=== create per-seed config ==="
# a throwaway config root: nothing is written under configs/
CFG_ROOT=${SAVE_DIR}/cfgs
mkdir -p ${CFG_ROOT}/voc
cp configs/Base-RCNN.yaml ${CFG_ROOT}/
cp configs/voc/defrcn_gfsod_r101_novelx_10shot_seedx.yaml ${CFG_ROOT}/voc/
python tools/create_config.py --dataset voc --config_root ${CFG_ROOT}/voc \
    --shot 10 --seed 0 --setting gfsod --split 1
CONFIG=${CFG_ROOT}/voc/defrcn_gfsod_r101_novel1_10shot_seed0.yaml

FT_GATE="[('bbox','nAP50',100.0,$((100-NOVEL_AP50_FLOOR))),('bbox','bAP50',100.0,$((100-BASE_AFTER_FT_FLOOR)))]"

# PCB off in the training legs (its effect would confound the floors); the
# pcb leg re-evaluates the ft model with a learned extractor

# ------------------------------------------------------------- control --
if has control; then
echo "=== control: surgered base model on the gfsod test set (no ft) ==="
python -m ${PORT}.cli --config-file ${CONFIG} --eval-only \
    --opts MODEL.WEIGHTS ${BASE_CKPT} TEST.PCB_ENABLE False \
    OUTPUT_DIR ${SAVE_DIR}/control ${TINY_OPTS} \
    2>&1 | tee ${SAVE_DIR}/control.log
fi

# ------------------------------------------------------------------ ft --
if has ft; then
echo "=== gfsod 10-shot fine-tune (production gradient contract) ==="
OUT=${SAVE_DIR}/10shot_seed0
python -m ${PORT}.cli --config-file ${CONFIG} \
    --opts MODEL.WEIGHTS ${BASE_CKPT} \
    SOLVER.MAX_ITER ${ITERS_FT} SOLVER.STEPS "($((ITERS_FT*4/5)),)" \
    SOLVER.BASE_LR 0.01 SOLVER.WARMUP_ITERS 50 OUTPUT_DIR ${OUT} \
    TEST.PCB_ENABLE False \
    TEST.EXPECTED_RESULTS "${FT_GATE}" ${TINY_OPTS} \
    2>&1 | tee ${OUT}.log
fi

# --------------------------------------------------------------- stats --
if has stats; then
echo "=== paired statistics ==="
need ${SAVE_DIR}/10shot_seed0.log stats ft
need ${SAVE_DIR}/control.log stats control
if [ -f ${SAVE_DIR}/base1.log ]; then
    BASE_AP50=$(metric ${SAVE_DIR}/base1.log 1)
else
    BASE_AP50="None"  # cached-base mode: no base eval to pair against
fi
FT_BAP50=$(metric ${SAVE_DIR}/10shot_seed0.log 4)
FT_NAP50=$(metric ${SAVE_DIR}/10shot_seed0.log 7)
CTRL_NAP50=$(metric ${SAVE_DIR}/control.log 7)
python - <<PYEOF
base, ft_b, ft_n, ctrl_n = ${BASE_AP50}, ${FT_BAP50}, ${FT_NAP50}, ${CTRL_NAP50}
gain = ft_n - ctrl_n
if base is not None:
    drop = base - ft_b
    print(f"paired stats: base AP50 {base:.2f} -> ft bAP50 {ft_b:.2f} "
          f"(drop {drop:.2f}, margin ${DROP_MARGIN})")
    assert drop <= ${DROP_MARGIN}, (
        f"fine-tune lost {drop:.2f} held-out base AP50 vs the base model "
        f"(> ${DROP_MARGIN}): base-class knowledge silently regressed")
print(f"paired stats: control nAP50 {ctrl_n:.2f} -> ft nAP50 {ft_n:.2f} "
      f"(gain {gain:.2f}, margin ${NOVEL_GAIN_MARGIN})")
assert gain >= ${NOVEL_GAIN_MARGIN}, (
    f"fine-tune gained only {gain:.2f} held-out novel AP50 over the "
    f"un-finetuned control (< ${NOVEL_GAIN_MARGIN}): few-shot learning "
    f"silently broken")
print("PAIRED STATS OK")
PYEOF
fi

# ------------------------------------------------------------------ ab --
if has ab; then
echo "=== contract A/B: sabotaged fine-tune (same seed) ==="
need ${SAVE_DIR}/10shot_seed0.log ab ft
# the discrimination proof of the GDL gradient contract: on this easy task
# a broken contract costs held-out base AP single digits, so the proof is
# a same-seed A/B against the clean ft leg, not an absolute floor
OUT=${SAVE_DIR}/ab_sab
python -m ${PORT}.cli --config-file ${CONFIG} \
    --opts MODEL.WEIGHTS ${BASE_CKPT} \
    SOLVER.MAX_ITER ${ITERS_FT} SOLVER.STEPS "($((ITERS_FT*4/5)),)" \
    SOLVER.BASE_LR 0.01 SOLVER.WARMUP_ITERS 50 OUTPUT_DIR ${OUT} \
    TEST.PCB_ENABLE False \
    MODEL.RPN.BACKWARD_SCALE 1.0 MODEL.ROI_HEADS.BACKWARD_SCALE 1.0 \
    MODEL.ROI_HEADS.FREEZE_FEAT False ${TINY_OPTS} \
    2>&1 | tee ${OUT}.log
CLEAN_BAP50=$(metric ${SAVE_DIR}/10shot_seed0.log 4)
SAB_BAP50=$(metric ${OUT}.log 4)
CLEAN_BAP=$(metric ${SAVE_DIR}/10shot_seed0.log 3)
SAB_BAP=$(metric ${OUT}.log 3)
python - <<PYEOF
# the asserted statistic is strict bAP (AP50:95): a broken contract
# degrades localization (res5 drift under full backprop) even on seeds
# where bAP50 barely moves
clean50, sab50 = ${CLEAN_BAP50}, ${SAB_BAP50}
clean, sab = ${CLEAN_BAP}, ${SAB_BAP}
print(f"held-out bAP50: clean={clean50:.2f} sabotaged={sab50:.2f} "
      f"delta={clean50-sab50:.2f} (informational)")
print(f"held-out bAP (50:95): clean={clean:.2f} sabotaged={sab:.2f} "
      f"delta={clean-sab:.2f} (margin ${SAB_MARGIN})")
assert clean - sab >= ${SAB_MARGIN}, "contract sabotage NOT detected"
print("SABOTAGE DETECTED: the gradient contract measurably protects "
      "held-out base AP")
PYEOF
fi

# ------------------------------------------------------------ semantic --
if has semantic; then
echo "=== semantic-head gfsod fine-tune (run_novel_pure_attention.sh) ==="
# SematicRes5ROIHeads under the plain meta-arch: attention over pooled ROI
# features against the class-embedding bank + the CE attention loss; held
# out and not GT-leaky
OUT=${SAVE_DIR}/semantic_ft
python -m ${PORT}.cli --config-file ${CONFIG} \
    --opts MODEL.WEIGHTS ${BASE_CKPT} \
    MODEL.ROI_HEADS.NAME SematicRes5ROIHeads \
    MODEL.ROI_HEADS.TEACHER_TRAINING True \
    MODEL.ROI_HEADS.STUDENT_TRAINING False \
    MODEL.ROI_HEADS.DISTILLATE False \
    MODEL.ADDITION.NAME glove \
    SOLVER.MAX_ITER ${ITERS_FT} SOLVER.STEPS "($((ITERS_FT*4/5)),)" \
    SOLVER.BASE_LR 0.01 SOLVER.WARMUP_ITERS 50 OUTPUT_DIR ${OUT} \
    TEST.PCB_ENABLE False \
    TEST.EXPECTED_RESULTS "[('bbox','nAP50',100.0,$((100-SEM_NOVEL_FLOOR))),('bbox','bAP50',100.0,$((100-SEM_BASE_FLOOR)))]" \
    ${TINY_OPTS} 2>&1 | tee ${OUT}.log
echo "SEMANTIC LEG PASSED"
fi

# ----------------------------------------------------------------- pcb --
if has pcb; then
echo "=== PCB effect leg: learned extractor + held-out rescoring ==="
# the alpha-blend rescoring (calibration_layer.py:106-124) tested for its
# effect: the extractor is PCB's own torchvision R-101 trained on GT crops
# of the train pool (train_pcb_extractor asserts that it learned)
need ${SAVE_DIR}/10shot_seed0.log pcb ft
PCB_EPS=${PCB_EPS:-3}
python -m ${PORT}.tools.train_pcb_extractor --data-root ${DATA_ROOT} \
    --out ${SAVE_DIR}/pcb_extractor.pth --iters ${PCB_TRAIN_ITERS:-200} \
    --device ${DEVICE} 2>&1 | tee ${SAVE_DIR}/pcb_train.log
python -m ${PORT}.cli --config-file ${CONFIG} --eval-only \
    --opts MODEL.WEIGHTS ${SAVE_DIR}/10shot_seed0/model_final.pth \
    TEST.PCB_ENABLE True \
    TEST.PCB_MODELPATH ${SAVE_DIR}/pcb_extractor.pth \
    OUTPUT_DIR ${SAVE_DIR}/pcb_eval ${TINY_OPTS} \
    2>&1 | tee ${SAVE_DIR}/pcb_eval.log
OFF_NAP50=$(metric ${SAVE_DIR}/10shot_seed0.log 7)
ON_NAP50=$(metric ${SAVE_DIR}/pcb_eval.log 7)
OFF_BAP50=$(metric ${SAVE_DIR}/10shot_seed0.log 4)
ON_BAP50=$(metric ${SAVE_DIR}/pcb_eval.log 4)
python - ${SAVE_DIR} <<PYEOF
import json, sys
off_n, on_n = ${OFF_NAP50}, ${ON_NAP50}
off_b, on_b = ${OFF_BAP50}, ${ON_BAP50}
print(f"held-out nAP50: PCB off {off_n:.2f} -> on {on_n:.2f} "
      f"(delta {on_n - off_n:+.2f}, eps ${PCB_EPS})")
print(f"held-out bAP50: PCB off {off_b:.2f} -> on {on_b:.2f} "
      f"(base classes are clsid-filtered on *_test_all — must be "
      f"IDENTICAL)")
# base classes are excluded from rescoring on the all split
# (calibration_layer clsid_filter); any bAP drift means the filter broke
assert abs(on_b - off_b) < 1e-6, "PCB rescored base-class detections"
assert on_n >= off_n - ${PCB_EPS}, (
    f"PCB-on lost {off_n - on_n:.2f} held-out novel AP50 (> ${PCB_EPS}): "
    f"the calibration hurts with a class-separable extractor")
# score-level contract on the detection dumps: PCB must actually have
# rescored (a silently disabled PCB passes the AP asserts), and only novel
# detections may change (base = contiguous ids 0-14 on the all1 split,
# novel = 15-19; calibration_layer.py:126-139)
sd = sys.argv[1]
key = lambda d: (d["image_id"], d["category_id"],
                 tuple(round(v, 2) for v in d["bbox"]))
off_scores = {key(d): d["score"] for d in json.load(
    open(f"{sd}/10shot_seed0/coco_instances_results.json"))}
changed_novel = changed_base = 0
for d in json.load(open(f"{sd}/pcb_eval/coco_instances_results.json")):
    s0 = off_scores.get(key(d))
    if s0 is not None and abs(d["score"] - s0) > 1e-6:
        if d["category_id"] >= 15:
            changed_novel += 1
        else:
            changed_base += 1
print(f"rescored detections: {changed_novel} novel, {changed_base} base")
assert changed_base == 0, "clsid filter broke: base scores changed"
assert changed_novel > 0, (
    "PCB changed NO novel scores — rescoring silently inactive")
print("PCB LEG PASSED")
PYEOF
fi

# ---------------------------------------------------------------- text --
if has text; then
echo "=== text-family base training (reference teacher recipe) ==="
# GeneralizedTextRCNN + TextRes5ROIHeads at the base stage
# (run_text_train_teacher.sh; TEACHER+STUDENT True, DISTILLATE False: the
# plain cross-entropy student; glove resolves to the synthetic vectors).
# The evaluation is the reference's own: test-time GT painted into the
# text map (GT-leaky by design).
OUTT=${SAVE_DIR}/text_base
python -m ${PORT}.cli --config-file configs/voc/defrcn_det_r101_base1.yaml \
    --opts MODEL.WEIGHTS "" \
    MODEL.META_ARCHITECTURE GeneralizedTextRCNN \
    MODEL.ROI_HEADS.NAME TextRes5ROIHeads \
    MODEL.ADDITION.NAME glove \
    MODEL.ROI_HEADS.TEACHER_TRAINING True \
    MODEL.ROI_HEADS.STUDENT_TRAINING True \
    MODEL.ROI_HEADS.DISTILLATE False \
    SOLVER.MAX_ITER ${ITERS_TEXT} \
    SOLVER.STEPS "($((ITERS_TEXT*3/4)),$((ITERS_TEXT*9/10)))" \
    SOLVER.BASE_LR 0.01 SOLVER.WARMUP_ITERS 100 OUTPUT_DIR ${OUTT} \
    TEST.EXPECTED_RESULTS "[('bbox','AP50',100.0,$((100-TEXT_AP50_FLOOR)))]" \
    ${TINY_OPTS} \
    2>&1 | tee ${OUTT}.log
fi

# ------------------------------------------------------------- serving --
if has serving; then
echo "=== text serving-path eval (NON-leaky: TEST.NO_GT_EVAL) ==="
need ${SAVE_DIR}/text_base/model_final.pth serving text
# the deployable path: no GT painted, the text map falls back to all
# background through the same fuse projection; a model that detects only
# when GT is painted fails this leg and passes the painted one
python -m ${PORT}.cli --config-file configs/voc/defrcn_det_r101_base1.yaml \
    --eval-only \
    --opts MODEL.WEIGHTS ${SAVE_DIR}/text_base/model_final.pth \
    MODEL.META_ARCHITECTURE GeneralizedTextRCNN \
    MODEL.ROI_HEADS.NAME TextRes5ROIHeads \
    MODEL.ADDITION.NAME glove \
    MODEL.ROI_HEADS.TEACHER_TRAINING True \
    MODEL.ROI_HEADS.STUDENT_TRAINING True \
    MODEL.ROI_HEADS.DISTILLATE False \
    TEST.NO_GT_EVAL True \
    OUTPUT_DIR ${SAVE_DIR}/text_serving \
    TEST.EXPECTED_RESULTS "[('bbox','AP50',100.0,$((100-SERVING_AP50_FLOOR)))]" \
    ${TINY_OPTS} 2>&1 | tee ${SAVE_DIR}/text_serving.log
echo "SERVING LEG PASSED"
fi

# ------------------------------------------------------------- distill --
if has distill; then
echo "=== two-stage teacher -> COLD student distillation ==="
need ${SAVE_DIR}/text_base/model_final.pth distill text
# run_text_train_Student.sh:26-33's distill combination: the student branch
# of the converged text teacher drawn afresh (reset_student surgery), then
# DISTILLATE + L2 + KL; the stage-2 stability constants of
# overfit_distill_check (RCNN lambda 0.001 + FREEZE_FEAT, KL_TEMP 2)
python -m ${PORT}.tools.model_surgery --dataset voc --method reset_student \
    --src-path ${SAVE_DIR}/text_base/model_final.pth \
    --save-dir ${SAVE_DIR}/text_base
OUTD=${SAVE_DIR}/distill_student
python -m ${PORT}.cli --config-file configs/voc/defrcn_det_r101_base1.yaml \
    --opts MODEL.WEIGHTS ${SAVE_DIR}/text_base/model_reset_student.pth \
    MODEL.META_ARCHITECTURE GeneralizedTextRCNN \
    MODEL.ROI_HEADS.NAME TextRes5ROIHeads \
    MODEL.ADDITION.NAME glove \
    MODEL.ROI_HEADS.TEACHER_TRAINING True \
    MODEL.ROI_HEADS.STUDENT_TRAINING True \
    MODEL.ROI_HEADS.DISTILLATE True \
    MODEL.ROI_HEADS.L2 True \
    MODEL.ROI_HEADS.KL_TEMP 2 \
    MODEL.ROI_HEADS.BACKWARD_SCALE 0.001 \
    MODEL.ROI_HEADS.FREEZE_FEAT True \
    SOLVER.MAX_ITER ${ITERS_DISTILL} \
    SOLVER.STEPS "($((ITERS_DISTILL*4/5)),)" \
    SOLVER.BASE_LR 0.01 SOLVER.WARMUP_ITERS 100 OUTPUT_DIR ${OUTD} \
    TEST.EXPECTED_RESULTS "[('bbox','AP50',100.0,$((100-DISTILL_AP50_FLOOR)))]" \
    ${TINY_OPTS} 2>&1 | tee ${OUTD}.log
echo "DISTILL LEG PASSED"
fi

echo "GENERALIZATION GATE PASSED (legs: ${LEGS})"
