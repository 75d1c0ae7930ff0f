#!/usr/bin/env bash
# Multi-temporal crop-classification replica: HLS chips cut against the
# published multi-temporal-crop-classification label chips. Mirrors the
# reference experiment (experiments_dir/data/crop_segmentation/
# us_cdl_replica.sh) on the instageo_tpu_torch CLI; records are CSVs of label
# rasters (label_filename,date) instead of the reference's gpkg.
set -euo pipefail

GCS_BUCKET=${GCS_BUCKET:-}
if [ -z "$GCS_BUCKET" ]; then
    echo "GCS_BUCKET is not set"
    exit 1
fi

mkdir -p data/train data/val

gsutil -m cp -r gs://instageo/data/multi-temporal-crop-classification .

for split in val train; do
    dir="validation_chips"; [ "$split" = train ] && dir="training_chips"
    python -m instageo_tpu_torch.data.raster_chip_creator \
        --raster_path "multi-temporal-crop-classification/${dir}" \
        --records_file "data/multi-temporal-crop-classification-${split}-records.csv" \
        --chip_size=224 \
        --temporal_step=50 \
        --num_steps=3 \
        --temporal_tolerance=20 \
        --cloud_coverage=30 \
        --output_directory "data/${split}" \
        --masking_strategy=any \
        --mask_types=cloud,near_cloud_or_shadow,cloud_shadow \
        --src_crs=5070 --spatial_resolution=30 \
        --daytime_only=false --qa_check=true 2>&1 | tee "data/${split}.log"
done

gsutil -m cp -r data \
    "${GCS_BUCKET}/data/multitemporal-crop-classification_replica"
