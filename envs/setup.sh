#!/usr/bin/env bash
# Environment setup (role parity with the reference's envs/ scripts).
#
# Plain venv, no conda requirement. CPU jax by default (what the tests
# need); set JAX_EXTRA=cuda12 on a machine with an NVIDIA GPU.
set -euo pipefail

PYTHON=${PYTHON:-python3}
VENV=${VENV:-.venv}

$PYTHON -m venv "$VENV"
# shellcheck disable=SC1091
source "$VENV/bin/activate"

pip install --upgrade pip
JAX_EXTRA=${JAX_EXTRA:-cpu}
pip install "jax[$JAX_EXTRA]" numpy scipy pandas pyyaml matplotlib pytest torch
pip install -e .

# native CSV ingest (optional; the loader falls back to numpy without it)
make -C native || echo "[setup] native build skipped (no toolchain)"

echo "[setup] done. Run: make test"
