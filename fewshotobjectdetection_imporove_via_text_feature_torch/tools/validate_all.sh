#!/usr/bin/env bash
# One-command validation ledger of the PyTorch package: runs its standing
# checks and prints PASS/FAIL (or SKIP) an item. The counterpart of the
# repository's tools/validate_all.sh, over this package's tools only.
#
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/validate_all.sh          # quick
#   bash fewshotobjectdetection_imporove_via_text_feature_torch/tools/validate_all.sh --full   # + tests and gates
#
# Quick: the VOC and COCO workflow smokes (smoke_workflow.sh,
# smoke_workflow_coco.sh), the multi-device dry run on CPU ranks
# (dryrun_multidevice, 2 ranks over gloo), and chip_smoke.py when a card is
# present. --full adds the port's CPU tests (tests/test_torch_*.py, which
# hold the port against the JAX package and need it installed) and the
# port's held-out gates (check_generalization.sh,
# check_generalization_coco.sh). The smokes and gates run on the card
# (MODEL.DEVICE cuda) unless DEVICE=cpu; without a card and without
# DEVICE=cpu they fail.
set -u
cd "$(dirname "$0")/../.."

PORT=fewshotobjectdetection_imporove_via_text_feature_torch
DEVICE=${DEVICE:-cuda}
TOOLS=${PORT}/tools
OUT=${TMPDIR:-/tmp}/validate_all_torch

FULL=0
[ "${1:-}" = "--full" ] && FULL=1

declare -a RESULTS=()
FAILED=0

run_step() {
    local name="$1"; shift
    echo
    echo "=== ${name} ==="
    if "$@"; then
        RESULTS+=("PASS  ${name}")
    else
        RESULTS+=("FAIL  ${name}")
        FAILED=1
    fi
}

has_card() {
    python -c "import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)"
}

run_step "VOC workflow smoke (${DEVICE})" \
    timeout 3000 bash ${TOOLS}/smoke_workflow.sh "${OUT}/voc" "${DEVICE}"
run_step "COCO workflow smoke (${DEVICE})" \
    timeout 3000 bash ${TOOLS}/smoke_workflow_coco.sh "${OUT}/coco" "${DEVICE}"
run_step "dryrun_multidevice (2 CPU ranks)" \
    timeout 1200 python -m ${PORT}.tools.dryrun_multidevice --ranks 2

if [ "$FULL" = 1 ]; then
    run_step "port CPU tests (tests/test_torch_*.py)" \
        timeout 3600 pytest -q -p no:cacheprovider tests/test_torch_*.py
    run_step "held-out generalization gate (VOC, ${DEVICE})" \
        env DEVICE=${DEVICE} timeout 7200 \
        bash ${TOOLS}/check_generalization.sh "${OUT}/gen"
    run_step "held-out generalization gate (COCO, ${DEVICE})" \
        env DEVICE=${DEVICE} timeout 4500 \
        bash ${TOOLS}/check_generalization_coco.sh "${OUT}/gen_coco"
fi

if has_card; then
    run_step "chip_smoke.py (every kernel and path on the card)" \
        timeout 1200 python3 chip_smoke.py
else
    echo
    echo "no CUDA card: chip_smoke.py skipped"
    RESULTS+=("SKIP  chip_smoke.py (no CUDA card)")
fi

echo
echo "================ validation ledger ================"
for r in "${RESULTS[@]}"; do echo "  $r"; done
echo "==================================================="
exit ${FAILED}
