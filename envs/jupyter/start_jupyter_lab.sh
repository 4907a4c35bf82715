#!/usr/bin/env bash
# Launch JupyterLab against the st-dadk environment (parity with the
# reference's envs/jupyter/start_jupyter_lab.sh; its SLURM plumbing is out
# of scope here — on a remote GPU host, forward the port with ssh).
#
#   ./envs/jupyter/start_jupyter_lab.sh [-p PORT]
#
# Remote use:  ssh -L 8888:localhost:8888 <gpu-host>
set -euo pipefail

PORT=8888
while [[ $# -gt 0 ]]; do
  case "$1" in
    -p|--port) PORT="$2"; shift 2 ;;
    *) echo "usage: $0 [-p PORT]" >&2; exit 2 ;;
  esac
done

command -v jupyter >/dev/null \
  || { echo "jupyter not installed (pip install jupyterlab)" >&2; exit 1; }

REPO="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
cd "$REPO"
exec jupyter lab --no-browser --ip=127.0.0.1 --port="$PORT"
