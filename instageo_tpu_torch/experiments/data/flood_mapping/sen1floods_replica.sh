#!/usr/bin/env bash
# Sen1Floods11 replica dataset: S2 chips (512 px, single timestep) cut
# against the Sen1Floods11 hand-labeled rasters. Mirrors the reference
# experiment (experiments_dir/data/flood_mapping/sen1floods_replica.sh)
# on the instageo_tpu_torch CLI; records are CSVs of label rasters
# (label_filename,date) instead of the reference's gpkg.
set -euo pipefail

GCS_BUCKET=${GCS_BUCKET:-}
DATA_DIR=${DATA_DIR:-data}
if [ -z "$GCS_BUCKET" ]; then
    echo "GCS_BUCKET is not set"
    exit 1
fi

mkdir -p "$DATA_DIR"
gsutil cp -r gs://instageo/data/observation_records/sen1floods/records/* "$DATA_DIR"

for split in val train test; do
    python -m instageo_tpu_torch.data.raster_chip_creator \
        --raster_path "$DATA_DIR/sen1floods11/LabelHand" \
        --records_file "$DATA_DIR/sen1floods-${split}-records.csv" \
        --chip_size=512 \
        --temporal_step=0 \
        --num_steps=1 \
        --temporal_tolerance=2 \
        --cloud_coverage=100 \
        --output_directory "$DATA_DIR/${split}" \
        --data_source=S2 \
        --src_crs=4326 --spatial_resolution=8.983152841195215e-05 \
        --daytime_only=false --qa_check=false 2>&1 | tee "$DATA_DIR/${split}.log"
done

gsutil -m cp -r "$DATA_DIR" "${GCS_BUCKET}/data/sen1floods_replica"
