#!/usr/bin/env bash
# Build the port's CUDA container image (Dockerfile.torch).  The kernels
# compile during the build, which needs no GPU.
set -euo pipefail
SCRIPTPATH="$(cd "$(dirname "$0")" && pwd)"
DOCKER_BUILDKIT=1 docker build -f "$SCRIPTPATH/Dockerfile.torch" \
  -t acouslicai_torch:v0.1.0 -t acouslicai_torch:latest "$SCRIPTPATH"
