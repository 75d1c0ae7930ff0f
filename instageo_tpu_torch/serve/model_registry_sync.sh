#!/usr/bin/env bash
# Sync deployable models from GCS to the local registry layout.
#
#   ./model_registry_sync.sh gs://bucket/models_registry.yaml /models
#
# Pulls the registry YAML, then for each model/size entry with a
# `gcs_folder`, rsyncs the checkpoint + .hydra config into
# {MODELS_PATH}/{model_key}/{size}/ (the layout serve/registry.py reads).
# The YAML is parsed by the port's own reader (configs/config.py:loads),
# so neither PyYAML nor yq is needed.
set -euo pipefail

if [[ $# -lt 2 ]]; then
  echo "Usage: $0 <gs://path/to/models_registry.yaml> <MODELS_DESTINATION_PATH>" >&2
  exit 1
fi

REGISTRY_URI="$1"
DEST="$2"
REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
mkdir -p "$DEST"
gsutil cp "$REGISTRY_URI" "$DEST/models_registry.yaml"

PYTHONPATH="$REPO_ROOT${PYTHONPATH:+:$PYTHONPATH}" python3 - "$DEST/models_registry.yaml" <<'PY' | while IFS=$'\t' read -r KEY SIZE FOLDER; do
import sys
from instageo_tpu_torch.configs.config import loads
with open(sys.argv[1]) as f:
    reg = loads(f.read()) or {}
for key, spec in (reg.get("models") or {}).items():
    for size, sz in (spec.get("sizes") or {}).items():
        folder = (sz or {}).get("gcs_folder")
        if folder:
            print(f"{key}\t{size}\t{folder}")
PY
  echo "Syncing ${KEY}/${SIZE} from ${FOLDER}"
  mkdir -p "$DEST/$KEY/$SIZE"
  gsutil -m rsync -r "$FOLDER" "$DEST/$KEY/$SIZE"
done

echo "Model registry synced to $DEST"
