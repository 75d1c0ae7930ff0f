#!/usr/bin/env bash
# Multi-temporal crop classification replica (Prithvi-V1-100M) on the
# published 13-class dataset — reference crop_class_replica.sh parity.
set -euo pipefail
MODEL=${MODEL:-prithvi_eo_v1_100} EXP_DIR=${EXP_DIR:-instageo_exp_cropreplica}
mkdir -p "$EXP_DIR"
python -m instageo_tpu_torch.train.run --config-name=multitemporal_crop_classification \
    run_dir="$EXP_DIR" root_dir='.' \
    model.model_name="$MODEL" \
    train.batch_size=8 train.num_epochs=100 \
    train_filepath='data/train.csv' valid_filepath='data/val.csv' \
    2>&1 | tee "$EXP_DIR/train.log"
python -m instageo_tpu_torch.train.run --config-path "$(pwd)/$EXP_DIR/.hydra" \
    --config-name=config root_dir='.' test_filepath='data/test.csv' \
    train.batch_size=64 checkpoint_path="$EXP_DIR/instageo_best_checkpoint" \
    mode=eval 2>&1 | tee "$EXP_DIR/test.log"
