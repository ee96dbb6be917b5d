#!/bin/bash
# Full-size rehearsal of the flagship recipe on the card, counterpart of the
# JAX package's scripts/rehearsal_flagship.sh.
#
# Runs the AutoProg recipe's shape end to end at a cut epoch count:
# volo_h12_l18 (volo_d1), 4 stages 128 -> 224 px, --auto-grow with 1 search
# epoch per boundary, token-label loss, 4-decay EMA, clone-ema growth, uint8
# batches, on synthetic data sized so that every grow boundary fires; then
# the same model trained at full size for the same epochs, for the
# wall-clock comparison; then validate.py on the AutoProg run's best
# checkpoint. `python -m autoprog_tpu_torch.scripts.analyze_rehearsal
# $OUT/autoprog/train/*/log.txt $OUT/fixed/train/*/log.txt` prints the
# per-stage table.
#
# Usage, from the root of the repository:
#   bash autoprog_tpu_torch/scripts/rehearsal_flagship.sh [OUTDIR]

OUT=${1:-output/rehearsal}
mkdir -p "$OUT"

COMMON="synthetic:// --num-classes 1000 --img-size 224 -b 128 \
 --warmup-epochs 1 --cooldown-epochs 0 --workers 8 --fake-data-size 8192 \
 --token-label --token-label-data synthetic:// --token-label-size 14 \
 --model-ema --model-ema-decay 0.998 0.9986 0.999 0.9996 \
 --uint8-pipe --lr 1.6e-3 --drop-path 0.1 --epochs 12 --seed 42"

echo "=== AutoProg rehearsal (12 epochs, 4 stages, search at 3 boundaries)"
python -m autoprog_tpu_torch.main_prog $COMMON --model volo_h12_l18 \
  --auto-grow --search-epochs 1 --num-stages 4 \
  --r-scale .5 --h-scale 1. --l-scale .5 --aa-scale .5 --dp-scale 0. \
  --re-scale 0. --resize-scale 1. 1. --load-with-clone-ema \
  --search-probe-steps 20 \
  --output "$OUT/autoprog" > "$OUT/autoprog.log" 2>&1
AP_RC=$?
echo "autoprog rc=$AP_RC"

echo "=== Fixed-schedule baseline (same model, same 12 epochs)"
python -m autoprog_tpu_torch.main $COMMON --model volo_h12_l18 \
  --output "$OUT/fixed" > "$OUT/fixed.log" 2>&1
FX_RC=$?
echo "fixed rc=$FX_RC"

echo "=== Checkpoint round-trip: standalone eval of the autoprog best"
BEST=$(ls "$OUT"/autoprog/train/*/model_best.ckpt 2>/dev/null | head -1)
if [ -n "$BEST" ]; then
  python -m autoprog_tpu_torch.validate synthetic:// --checkpoint "$BEST" \
    --num-classes 1000 --img-size 224 -b 128 --workers 4 \
    --fake-data-size 1024 > "$OUT/validate.log" 2>&1
  echo "validate rc=$?"
fi
echo "DONE AP_RC=$AP_RC FX_RC=$FX_RC"
