#!/usr/bin/env bash
# BDD100K drivable-area recipe sweep on the card (the reference's second
# trainer, train_bdd100k.py: 2-class dice + aux, AdamW lr 1e-3, images at
# 360x640), through the port's bench_train. The port of
# tools/sweep_bdd.sh, with the same legs and knobs.
#
# Legs:
#   1. host-aug-fed 360x640 AdamW, batch 8 -> the knee
#   2. the keep-original-size device-aug chain (native-resolution flip +
#      blur on the card, data/device_aug.py make_device_augment_original)
#      at the same batches
#
# One bench process on the card at a time. Results append to $OUT
# (default build/sweep_bdd.jsonl), the benches' stderr to $ERR (default
# build/sweep_bdd_err.log). PYTHON names the interpreter (default:
# python); it runs from the repo root.
set -u
cd "$(dirname "$0")/../.."
PY=${PYTHON:-python}
OUT=${OUT:-build/sweep_bdd.jsonl}
ERR=${ERR:-build/sweep_bdd_err.log}
ITERS=${ITERS:-20}
mkdir -p "$(dirname "$OUT")" "$(dirname "$ERR")"

run() {
  echo "### $*" >> "$OUT"
  env "$@" BENCH_TRAIN_ITERS=$ITERS $PY -m fastscnn_tpu_torch.bench_train >> "$OUT" 2>"$ERR" \
    || echo "{\"error\": \"$* failed\"}" >> "$OUT"
  tail -1 "$OUT"
}

# leg 1: host-aug 360x640 AdamW dice-2
run BENCH_TRAIN_SIZE=360x640 BENCH_TRAIN_OPT=adamw BENCH_TRAIN_CLASSES=2 \
    BENCH_TRAIN_LOSS=dice BENCH_TRAIN_BATCHES=8,32,64,128,192

# leg 2: device-aug keep-original-size chain at the same resolution
run BENCH_TRAIN_SRC=360x640 BENCH_TRAIN_DEVICE_AUG=1 BENCH_TRAIN_AUG_CHAIN=original \
    BENCH_TRAIN_OPT=adamw BENCH_TRAIN_CLASSES=2 BENCH_TRAIN_LOSS=dice \
    BENCH_TRAIN_BATCHES=8,32,64,128,192

# control: SGD at the same size (isolates the optimizer's cost)
run BENCH_TRAIN_SIZE=360x640 BENCH_TRAIN_CLASSES=2 BENCH_TRAIN_LOSS=dice \
    BENCH_TRAIN_BATCHES=64,128
