#!/usr/bin/env bash
# Build the st-dadk conda environment (parity with the reference's
# envs/conda/build_conda_env.sh, minus its cluster-specific module loads).
#
#   ./envs/conda/build_conda_env.sh [-c ENV_NAME]
set -euo pipefail

ENV_NAME="st-dadk"
while [[ $# -gt 0 ]]; do
  case "$1" in
    -c|--conda_env) ENV_NAME="$2"; shift 2 ;;
    *) echo "usage: $0 [-c ENV_NAME]" >&2; exit 2 ;;
  esac
done

HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
command -v conda >/dev/null || { echo "conda not found on PATH" >&2; exit 1; }

if conda env list | awk '{print $1}' | grep -qx "$ENV_NAME"; then
  echo "[conda] env '$ENV_NAME' exists; updating"
  conda env update -n "$ENV_NAME" -f "$HERE/environment.yml" --prune
else
  conda env create -n "$ENV_NAME" -f "$HERE/environment.yml"
fi

# optional native CSV ingest (loader falls back to numpy without it)
make -C "$HERE/../../native" 2>/dev/null \
  || echo "[conda] native build skipped (no C++ toolchain)"

echo "[conda] done. Activate with: conda activate $ENV_NAME"
