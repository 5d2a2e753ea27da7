#!/usr/bin/env bash
# Run the port's container entry point without docker: reads
# ./test/input and writes ./test/output under RUN_DIR (default: this
# repository).  The environment passes through (MODEL_TAG, WEIGHTS, PLANS,
# DATASET_JSON, CASE_ID); DEVICE defaults to cuda, as the entry point's
# does: DEVICE=cpu runs the kernels' plain versions.
set -euo pipefail
SCRIPTPATH="$(cd "$(dirname "$0")" && pwd)"
cd "${RUN_DIR:-$SCRIPTPATH}"
PYTHONPATH="$SCRIPTPATH${PYTHONPATH:+:$PYTHONPATH}" DEVICE="${DEVICE:-cuda}" \
  python -m att_aspp_unet_tpu_torch.inference
echo "outputs in $(pwd)/test/output"
