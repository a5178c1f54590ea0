#!/usr/bin/env bash
# CE-19 Cityscapes-recipe training-throughput sweep on the card: batch x
# grad-accum x device-aug, through the port's bench_train (one CUDA graph
# of the step replayed; grad-accum runs bench the shipped make_train_step
# via BENCH_TRAIN_GRAD_ACCUM). The port of tools/sweep_ce19.sh, with the
# same legs, knobs and timeouts.
#
# The recipe: 19-class OHEM-CE + aux, 768^2 crops (the reference's
# train.py defaults). A batch that runs out of memory prints its error
# line and the sweep goes on.
#
# One bench process on the card at a time. PYTHON names the interpreter
# (default: python); it runs from the repo root.
set -u
cd "$(dirname "$0")/../.."
PY=${PYTHON:-python}

CE="BENCH_TRAIN_CLASSES=19 BENCH_TRAIN_LOSS=ce BENCH_TRAIN_CROP=768"

run() {  # run <extra-env...>
  echo "--- $*"
  env $CE "$@" BENCH_TRAIN_ITERS=20 timeout 1500 $PY -m fastscnn_tpu_torch.bench_train
}

echo "== CE-19 768² batch sweep, no accumulation =="
run BENCH_TRAIN_BATCHES=16,24,32,48

echo "== grad-accum: same microbatch sizes, amortized update =="
run BENCH_TRAIN_BATCHES=64  BENCH_TRAIN_GRAD_ACCUM=2   # mb 32
run BENCH_TRAIN_BATCHES=64  BENCH_TRAIN_GRAD_ACCUM=4   # mb 16
run BENCH_TRAIN_BATCHES=96  BENCH_TRAIN_GRAD_ACCUM=3   # mb 32
run BENCH_TRAIN_BATCHES=128 BENCH_TRAIN_GRAD_ACCUM=4   # mb 32
run BENCH_TRAIN_BATCHES=128 BENCH_TRAIN_GRAD_ACCUM=8   # mb 16

echo "== device-aug arms (native 1024×2048 citys frames, PSP chain on device) =="
run BENCH_TRAIN_BATCHES=16 BENCH_TRAIN_DEVICE_AUG=1 \
    BENCH_TRAIN_SRC=1024x2048 BENCH_TRAIN_BASE=1024
run BENCH_TRAIN_BATCHES=64 BENCH_TRAIN_GRAD_ACCUM=4 BENCH_TRAIN_DEVICE_AUG=1 \
    BENCH_TRAIN_SRC=1024x2048 BENCH_TRAIN_BASE=1024

echo "== done =="
