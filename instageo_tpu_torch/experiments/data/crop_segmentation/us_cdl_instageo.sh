#!/usr/bin/env bash
# Expanded multi-temporal crop-classification dataset from the nationwide
# US Cropland Data Layer: window the CDL raster into intermediate labels,
# then cut HLS chips (3 timesteps, 50-day step) against them. Mirrors the
# reference experiment (experiments_dir/data/crop_segmentation/
# us_cdl_instageo.sh) on the instageo_tpu_torch CLI.
set -euo pipefail

GCS_BUCKET=${GCS_BUCKET:-}
if [ -z "$GCS_BUCKET" ]; then
    echo "GCS_BUCKET is not set"
    exit 1
fi

mkdir -p data intermediate_labels

# 2024 US CDL raster (swap in 2022_30m_cdls.tif for the 2022 dataset).
gsutil cp gs://instageo/data/observation_records/us_cdls/2024_30m_cdls.tif \
    data/us_cdl_raster.tif

python instageo_tpu_torch/experiments/utils/create_us_cdl_records.py \
    --raster-path data/us_cdl_raster.tif \
    --records-file data/us_cdl_records.csv \
    --date 2024-09-01 \
    --output-path intermediate_labels

export DATAPIPELINESETTINGS_BATCH_SIZE=10

python -m instageo_tpu_torch.data.raster_chip_creator \
    --raster_path intermediate_labels \
    --records_file data/us_cdl_records.csv \
    --temporal_step=50 \
    --num_steps=3 \
    --temporal_tolerance=20 \
    --cloud_coverage=30 \
    --output_directory data \
    --masking_strategy=any \
    --mask_types=cloud,near_cloud_or_shadow,cloud_shadow \
    --src_crs=5070 --spatial_resolution=30 \
    --daytime_only=false --qa_check=true 2>&1 | tee data/us_cdl.log

gsutil -m cp -r data \
    "${GCS_BUCKET}/data/multitemporal-crop-classification-instageo"
