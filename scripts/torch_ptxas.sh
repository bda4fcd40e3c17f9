#!/usr/bin/env bash
# Registers, shared memory and spills of every kernel of the PyTorch
# port, as ptxas reports them: compiles each src/repro_torch/csrc/*.cu,
# csrc/native/*.cu, csrc/spec_accel/*.cu and csrc/miniqmc/*.cu with the
# port's nvcc flags for the card (the sm_90a target part of the device
# runtime, csrc/rt/) plus -Xptxas -v into a throw-away object; each
# spec_accel and miniqmc source a second time with -DREPRO_RT_NATIVE
# (its native build, against csrc/native/rt_native.cuh).
# Needs the CUDA toolkit (nvcc on PATH or under $CUDA_HOME).
#
#   scripts/torch_ptxas.sh [source.cu ...]
set -euo pipefail
cd "$(dirname "$0")/.."
NVCC=$(command -v nvcc || echo "${CUDA_HOME:-/usr/local/cuda}/bin/nvcc")
CSRC=src/repro_torch/csrc
OUT=$(mktemp -d)
trap 'rm -rf "$OUT"' EXIT
srcs=("$@")
[ ${#srcs[@]} -gt 0 ] ||
  srcs=("$CSRC"/*.cu "$CSRC"/native/*.cu "$CSRC"/spec_accel/*.cu
    "$CSRC"/miniqmc/*.cu)
ptxas() {  # source, extra flags...
  local src=$1
  shift
  echo "== $(basename "$src") $*"
  "$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 "$@" \
    -Xptxas -v -I "$CSRC" -c -o "$OUT/$(basename "$src").o" "$src" 2>&1 |
    grep -E "Compiling entry|Used|spill|error" | sed 's/^ptxas info *: *//'
}
for src in "${srcs[@]}"; do
  ptxas "$src"
  case "$src" in */spec_accel/* | */miniqmc/*) ptxas "$src" -DREPRO_RT_NATIVE ;; esac
done
