#!/usr/bin/env bash
# The per-device dry-run counts of the port at full width, on the host's
# CPU (meta tensors; no card): Granite-3-2B's three shapes on 16x16 under
# every preset and on 2x16x16 under baseline and tp, its one-card count
# beside them, and every other family's prefill_32k and decode_32k on
# 16x16 under tp (~40 min on an 8-core host, most of it Granite's 16 cp
# classes and RWKV-6's step loop). The records go to
# build/dryrun_torch.json; the roofline table of one mesh and preset is
#   PYTHONPATH=src python -m repro_torch.launch.roofline --mesh 16x16 --rules tp
#
#   bash scripts/dryrun_meshes.sh [--skip-done]
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
run() { python -m repro_torch.launch.dryrun "$@"; }

run --one-card --arch granite-3-2b --shape train_4k "$@"
for rules in baseline tp serve8 kv8 cp; do
  run --arch granite-3-2b --rules "$rules" "$@"
done
for rules in baseline tp; do
  run --multi-pod --arch granite-3-2b --rules "$rules" "$@"
done
for arch in qwen2-vl-7b qwen2.5-32b granite-20b qwen1.5-110b \
    whisper-large-v3 moonshot-v1-16b-a3b mixtral-8x7b hymba-1.5b rwkv6-3b; do
  for shape in prefill_32k decode_32k; do
    run --arch "$arch" --shape "$shape" --rules tp "$@"
  done
done
