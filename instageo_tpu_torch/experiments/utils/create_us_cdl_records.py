"""Split a US CDL raster into windowed label rasters + a records CSV.

Counterpart of the reference's ``experiments_dir/utils/
create_instageo_us_cdl_records.py`` (invoked by
``experiments_dir/data/crop_segmentation/us_cdl_instageo.sh`` but not
shipped in the repository): cuts the nationwide Cropland Data Layer
raster into window-sized intermediate label rasters and writes the
``label_filename,date`` records CSV that ``raster_chip_creator``
consumes (``--records_file`` / ``--raster_path``).

Windows that are entirely no-data are skipped. The raster is read in
full before slicing (the in-repo codec has no windowed reads); for the
nationwide 30 m CDL mosaic run this on a high-memory host or pre-crop
the raster to your AOI.

The port's copy of ``experiments/utils/create_us_cdl_records.py``, over
its own GeoTIFF codec and ``data/table.py`` (no pandas): the same files.

Usage (mirrors the reference script's flags)::

    python instageo_tpu_torch/experiments/utils/create_us_cdl_records.py \
        --raster-path data/us_cdl_raster.tif \
        --records-file data/us_cdl_records.csv \
        --date 2024-09-01 \
        --output-path intermediate_labels
"""

from __future__ import annotations

import argparse
import os
import sys

# Runnable from anywhere without installing the package.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--raster-path", required=True,
                    help="Input CDL GeoTIFF (single band, class codes).")
    ap.add_argument("--records-file", required=True,
                    help="Output records CSV (label_filename,date).")
    ap.add_argument("--date", required=True,
                    help="Observation date stamped on every record.")
    ap.add_argument("--output-path", required=True,
                    help="Directory for the windowed label rasters.")
    ap.add_argument("--window-size", type=int, default=224 * 3,
                    help="Window edge in pixels (default 672 = 3 chips).")
    ap.add_argument("--nodata", type=float, default=0,
                    help="No-data value in the CDL raster (default 0).")
    args = ap.parse_args()

    from instageo_tpu_torch.data.geotiff import Affine, GeoTiffReader, write_geotiff
    from instageo_tpu_torch.data.table import columns_of, write_csv

    os.makedirs(args.output_path, exist_ok=True)
    with GeoTiffReader(args.raster_path) as r:
        arr = r.read(1)
        transform, crs = r.transform, r.crs
        nodata = r.nodata if r.nodata is not None else args.nodata

    w = args.window_size
    rows = []
    for i0 in range(0, arr.shape[0], w):
        for j0 in range(0, arr.shape[1], w):
            window = arr[i0:i0 + w, j0:j0 + w]
            if (window == nodata).all():
                continue
            x, y = transform * (j0, i0)
            t = Affine(transform.a, transform.b, x,
                       transform.d, transform.e, y)
            name = f"cdl_window_{i0}_{j0}.tif"
            write_geotiff(os.path.join(args.output_path, name),
                          window[None], transform=t, crs=crs,
                          nodata=nodata)
            rows.append({"label_filename": name, "date": args.date})

    write_csv(args.records_file, rows, columns_of(rows))
    print(f"Wrote {len(rows)} label windows to {args.output_path} and "
          f"records to {args.records_file}")


if __name__ == "__main__":
    main()
