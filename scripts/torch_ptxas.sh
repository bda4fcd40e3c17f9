#!/usr/bin/env bash
# Registers, shared memory and spills of every kernel of the PyTorch
# port, as ptxas reports them: compiles each src/repro_torch/csrc/*.cu
# and csrc/native/*.cu with the port's nvcc flags for the card (the
# sm_90a target part of the device runtime, csrc/rt/) plus -Xptxas -v
# into a throw-away object.
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
[ ${#srcs[@]} -gt 0 ] || srcs=("$CSRC"/*.cu "$CSRC"/native/*.cu)
for src in "${srcs[@]}"; do
  echo "== $(basename "$src")"
  "$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
    -Xptxas -v -I "$CSRC" -c -o "$OUT/$(basename "$src").o" "$src" 2>&1 |
    grep -E "Compiling entry|Used|spill" | sed 's/^ptxas info *: *//'
done
