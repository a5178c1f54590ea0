#!/usr/bin/env bash
# Interleaved A/B of the port's stem-conv implementations on the card.
# (fastscnn_tpu_torch/tools/ab_stem.sh; the port of tools/ab_stem.sh, with
# the same legs, order, repeats, knobs and timeouts.)
#
# Serving: BENCH_DW_IMPL in {conv, taps, pallas (kernel B4), fused-ds (B3),
# fused-ds-mr (B5)} through the port's bench (batch 128 only, two
# interleaved repeats: numbers drift from run to run, so only the
# within-script ordering A/B/A/B is trustworthy).
#
# Training: the Cityscapes recipe (19-class CE 768^2 bs16) and the dice2
# 480^2 bs128 config through the port's bench_train with BENCH_TRAIN_STEM
# in {xla, tapbwd, taps, taps-packbn, pallas (B6)}.
#
# Run from anywhere; it runs from the repo root. PYTHON names the
# interpreter (default: python). Send its output to a log and summarize it
# with ab_report, which this script runs last on AB_LOG (default
# build/ab_stem_results.log):
#
#   mkdir -p build
#   fastscnn_tpu_torch/tools/ab_stem.sh 2>&1 | tee build/ab_stem_results.log
set -u
cd "$(dirname "$0")/../.."
PY=${PYTHON:-python}

echo "== device mask parity across dw impls (gates the fps numbers) =="
timeout 1800 $PY -m fastscnn_tpu_torch.tools.check_dw_impls --height 512 --width 1024 --batch 4

echo "== serving: folded dw impl (batch 128, 1024x2048 bf16) =="
for rep in 1 2; do
  for impl in conv taps pallas fused-ds fused-ds-mr; do
    echo "--- rep $rep dw_impl=$impl"
    BENCH_DW_IMPL=$impl BENCH_BATCHES=128 BENCH_TRIALS=3 timeout 1200 $PY -m fastscnn_tpu_torch.bench
  done
done

echo "== training: stem impl (ce19 768^2 bs16 — the Cityscapes recipe) =="
for rep in 1 2; do
  for impl in xla tapbwd taps taps-packbn pallas; do
    echo "--- rep $rep stem_impl=$impl"
    BENCH_TRAIN_STEM=$impl BENCH_TRAIN_CLASSES=19 BENCH_TRAIN_LOSS=ce \
      BENCH_TRAIN_CROP=768 BENCH_TRAIN_BATCHES=16 BENCH_TRAIN_ITERS=20 \
      timeout 1200 $PY -m fastscnn_tpu_torch.bench_train
  done
done

echo "== training: stem impl (dice2 480^2 bs128 — the headline config) =="
for rep in 1 2; do
  for impl in xla taps taps-packbn; do
    echo "--- rep $rep stem_impl=$impl"
    BENCH_TRAIN_STEM=$impl BENCH_TRAIN_BATCHES=128 BENCH_TRAIN_ITERS=20 \
      timeout 1200 $PY -m fastscnn_tpu_torch.bench_train
  done
done

echo "== summary =="
$PY -m fastscnn_tpu_torch.tools.ab_report "${AB_LOG:-build/ab_stem_results.log}" 2>/dev/null || true
