#!/usr/bin/env bash
# Sen1Floods11 replica, end to end, ONE command:
#
#   PRITHVI_PRETRAINED_PATH=/path/Prithvi_100M.pt \
#       bash instageo_tpu_torch/experiments/sen1floods_runbook.sh
#
# On a weights+network-connected machine this produces the reference
# README-table row (mIoU/Acc/mF1/ROC-AUC vs InstaGeo-Baseline 88.53,
# reference README.md:31) unattended in $EXP_DIR/REPORT.md. Every
# environment gate fails fast with instructions; every post-data stage
# is the same code CI exercises on synthetic fixtures
# (tests/model_tests/test_replica_mode.py).
set -euo pipefail
cd "$(dirname "$0")/../.."

EXP_DIR=${EXP_DIR:-instageo_exp}
DATA_DIR=${DATA_DIR:-data}

# ---- Gate 1: pretrained encoder weights (zero-egress images stop here).
: "${PRITHVI_PRETRAINED_PATH:?export PRITHVI_PRETRAINED_PATH=<Prithvi_100M.pt> — download per MIGRATION.md 'Pretrained weights'}"
[ -f "$PRITHVI_PRETRAINED_PATH" ] || {
    echo "PRITHVI_PRETRAINED_PATH=$PRITHVI_PRETRAINED_PATH does not exist" >&2
    exit 2
}

# ---- Gate 2: chip manifests. If absent, cut chips from the Sen1Floods11
# hand labels (network + gsutil needed — instageo_tpu_torch/experiments/data/.../sen1floods_replica.sh).
if [ ! -f "$DATA_DIR/train.csv" ] || [ ! -f "$DATA_DIR/val.csv" ] || [ ! -f "$DATA_DIR/test.csv" ]; then
    echo "Chip manifests missing under $DATA_DIR/ — running the data stage..."
    command -v gsutil >/dev/null || {
        echo "gsutil not available: stage the chips manually (see" \
             "instageo_tpu_torch/experiments/data/flood_mapping/sen1floods_replica.sh) or" \
             "point DATA_DIR at an existing dataset" >&2
        exit 3
    }
    GCS_BUCKET=${GCS_BUCKET:?export GCS_BUCKET=gs://<your-bucket> for the data stage} \
        DATA_DIR="$DATA_DIR" \
        bash instageo_tpu_torch/experiments/data/flood_mapping/sen1floods_replica.sh
    # Promote each split's pipeline manifest ({split}/s2_raster_dataset.csv,
    # data/pipeline.py run()) to the {split}.csv name the train stage reads.
    for split in train val test; do
        [ -f "$DATA_DIR/$split.csv" ] ||
            cp "$DATA_DIR/$split/s2_raster_dataset.csv" "$DATA_DIR/$split.csv"
    done
fi

# ---- Stages 3-6: stats → train → eval(val,test) → report, one command.
DATA_DIR="$DATA_DIR" EXP_DIR="$EXP_DIR" \
    bash instageo_tpu_torch/experiments/train/flood_mapping/sen1floods_replica.sh

echo "Done. Paste-ready table: $EXP_DIR/REPORT.md"
