#!/usr/bin/env bash
# Chunked multi-method AL campaign driver (counterpart of
# nnal_tpu/cli/run_experiments.sh): create the experiment if missing, then
# loop methods x query chunks, one process per chunk, so a long campaign
# survives restarts (each chunk resumes from the queries journal).
#
# usage: run_experiments.sh ROOT "method1 method2" TOTAL_QUERIES CHUNK \
#            [OVERRIDES] [cpu]
#
# Runs on the card; a sixth argument "cpu" runs on the host
# (--device cpu). Without CUDA and without "cpu" the first chunk raises.

set -euo pipefail

ROOT=${1:?experiment root}
METHODS=${2:?space-separated method list}
TOTAL=${3:?total queries}
CHUNK=${4:-10}
OVERRIDES=${5:-}
DEVICE=${6:-}

DEVICE_ARGS=()
case "$DEVICE" in
  "") ;;
  cpu) DEVICE_ARGS=(--device cpu) ;;
  *) echo "run_experiments.sh: the sixth argument is 'cpu' or nothing," \
          "not '$DEVICE'" >&2; exit 2 ;;
esac

for METHOD in $METHODS; do
  DONE=0
  while [ "$DONE" -lt "$TOTAL" ]; do
    TARGET=$(( DONE + CHUNK < TOTAL ? DONE + CHUNK : TOTAL ))
    python -m nnal_tpu_torch.cli.expr_handler \
      "$ROOT" "$METHOD" "$TARGET" "$OVERRIDES" --synthetic \
      ${DEVICE_ARGS[@]+"${DEVICE_ARGS[@]}"}
    DONE=$TARGET
  done
done
