#!/usr/bin/env bash
# Multi-temporal crop segmentation 2022 (Prithvi-V2-300M, bs=32, wd=0.01,
# class weights computed via stats mode, 100 epochs). Mirrors the reference
# cropclass2022.sh workflow on the instageo_tpu_torch CLI.
set -euo pipefail
MODEL=${MODEL:-prithvi_eo_v2_300}
EXP_DIR=${EXP_DIR:-instageo_exp_crop}
mkdir -p "$EXP_DIR"

echo "Computing dataset statistics (mean/std/class weights)..."
STATS=$(python -m instageo_tpu_torch.train.run --config-name=multitemporal_crop_classification \
    mode=stats root_dir='.' train_filepath='data/train.csv' | tail -n 1)
MEAN=$(echo "$STATS" | python -c "import sys,json;print(','.join(map(str,json.load(sys.stdin)['mean'])))")
STD=$(echo "$STATS" | python -c "import sys,json;print(','.join(map(str,json.load(sys.stdin)['std'])))")
CW=$(echo "$STATS" | python -c "import sys,json;print(','.join(map(str,json.load(sys.stdin)['class_weights'])))")

echo "Start Training..."
python -m instageo_tpu_torch.train.run --config-name=multitemporal_crop_classification \
    run_dir="$EXP_DIR" \
    root_dir='.' \
    "dataloader.mean=[${MEAN}]" \
    "dataloader.std=[${STD}]" \
    "train.class_weights=[${CW}]" \
    train.weight_decay=0.01 \
    train.batch_size=32 \
    train.num_epochs=100 \
    model.model_name="$MODEL" \
    train_filepath='data/train.csv' \
    valid_filepath='data/val.csv' 2>&1 | tee "$EXP_DIR/train.log"

echo "Evaluating Test Split..."
python -m instageo_tpu_torch.train.run --config-path "$(pwd)/$EXP_DIR/.hydra" \
    --config-name=config \
    root_dir='.' test_filepath='data/test.csv' train.batch_size=64 \
    checkpoint_path="$EXP_DIR/instageo_best_checkpoint" \
    mode=eval 2>&1 | tee "$EXP_DIR/test.log"
