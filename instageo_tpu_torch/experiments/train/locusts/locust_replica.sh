#!/usr/bin/env bash
# Locust breeding-ground replication (Prithvi-V1-100M, bs=8, wd=0.3,
# 30 epochs, raw-reflectance statistics). Mirrors the reference
# locust_replica.sh workflow on the instageo_tpu_torch CLI.
set -euo pipefail
MODEL=${MODEL:-prithvi_eo_v1_100}
EXP_DIR=${EXP_DIR:-instageo_exp_locust}
mkdir -p "$EXP_DIR"

python -m instageo_tpu_torch.train.run --config-name=locust \
    run_dir="$EXP_DIR" \
    root_dir='.' \
    train.weight_decay=0.3 \
    train.batch_size=8 \
    train.num_epochs=30 \
    model.model_name="$MODEL" \
    train_filepath='data/train.csv' \
    valid_filepath='data/val.csv' 2>&1 | tee "$EXP_DIR/train.log"

python -m instageo_tpu_torch.train.run --config-path "$(pwd)/$EXP_DIR/.hydra" \
    --config-name=config \
    root_dir='.' test_filepath='data/test.csv' train.batch_size=64 \
    checkpoint_path="$EXP_DIR/instageo_best_checkpoint" \
    mode=eval 2>&1 | tee "$EXP_DIR/test.log"
