#!/usr/bin/env bash
# Grand-Challenge-faithful run of the port's image on a GPU host: rebuild,
# run with every GPU, no network, a no-op /tmp volume, /input read-only and
# /output bind mounts, then fix output ownership.
set -euo pipefail
SCRIPTPATH="$(cd "$(dirname "$0")" && pwd)"

"$SCRIPTPATH/build_torch.sh"

VOLUME="acouslicai_torch-output-$RANDOM"
docker volume create "$VOLUME"
# the image's user is not the host's: it must be able to write /output
mkdir -p "$SCRIPTPATH/test/output"
chmod a+rwx "$SCRIPTPATH/test/output"

docker run --rm \
  --gpus all \
  --network none \
  --memory 32g --shm-size 2g \
  -v "$SCRIPTPATH/test/input":/input:ro \
  -v "$SCRIPTPATH/test/output":/output \
  -v "$VOLUME":/tmp \
  acouslicai_torch:latest

docker run --rm \
  -v "$SCRIPTPATH/test/output":/output \
  --entrypoint /bin/sh acouslicai_torch:latest \
  -c "chown -R $(id -u):$(id -g) /output" || true

docker volume rm "$VOLUME"
echo "outputs in $SCRIPTPATH/test/output"
