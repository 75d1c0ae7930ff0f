#!/usr/bin/env bash
# Sen1Floods11 replication on the card: Prithvi-V1-100M, bs=16, wd=0.1, cw=[1,3],
# 100 epochs. Mirrors the reference experiment
# (experiments_dir/train/flood_mapping/sen1floods_replica.sh) on the
# instageo_tpu_torch CLI — but as ONE command: mode=replica chains stats →
# train → val/test eval → BASELINE-format report (train/replica.py).
# Expects data/{train,val,test}.csv chip manifests and a local pretrained
# encoder at $PRITHVI_PRETRAINED_PATH (or model.pretrained_path=...).
set -euo pipefail
MODEL=${MODEL:-prithvi_eo_v1_100}
EXP_DIR=${EXP_DIR:-instageo_exp}
DATA_DIR=${DATA_DIR:-data}

mkdir -p "$EXP_DIR"
python -m instageo_tpu_torch.train.run --config-name=sen1floods11 \
    mode=replica \
    run_dir="$EXP_DIR" \
    root_dir='.' \
    dataloader.no_data_value=0 \
    "dataloader.bands=[0,1,2,3,4,5]" \
    "train.class_weights=[1,3]" \
    model.freeze_backbone=False \
    train.weight_decay=0.1 \
    train.batch_size=16 \
    train.num_epochs=100 \
    model.model_name="$MODEL" \
    train_filepath="$DATA_DIR/train.csv" \
    valid_filepath="$DATA_DIR/val.csv" \
    test_filepath="$DATA_DIR/test.csv" 2>&1 | tee "$EXP_DIR/replica.log"

echo "Report: $EXP_DIR/REPORT.md"
cat "$EXP_DIR/REPORT.md"
