#!/usr/bin/env bash
# Export the port's container image as a gzipped tarball for upload.
set -euo pipefail
docker save acouslicai_torch:latest | gzip -c > acouslicai_torch.tar.gz
echo "wrote acouslicai_torch.tar.gz"
