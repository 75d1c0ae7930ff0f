#!/usr/bin/env bash
# Locust breeding-ground replica dataset: HLS chips (224 px, 3 timesteps,
# 30-day step) from point observations. Mirrors the reference experiment
# (experiments_dir/data/locusts/locust_replica.sh) on the instageo_tpu_torch CLI.
set -euo pipefail

mkdir -p data
gsutil -m cp gs://instageo/data/locust_breeding/records/* data

for split in train val test; do
    python -m instageo_tpu_torch.data.chip_creator \
        --dataframe_path="data/${split}.csv" \
        --output_directory="data/${split}" \
        --min_count=1 \
        --chip_size=224 \
        --temporal_tolerance=5 \
        --temporal_step=30 \
        --num_steps=3 \
        --masking_strategy=each \
        --mask_types=cloud \
        --data_source=HLS \
        --cloud_coverage=100 \
        --processing_method=cog 2>&1 | tee "data/locust_replica_${split}.log"
done

gsutil -m cp -r data gs://instageo/data/locust-replica
