"""Write the Parquet fixture that the port's reader is held to where pyarrow
is missing (``tests/torch_fixtures/observations.parquet``) and its expected
records (``observations.json``).

The file is what a user of the JAX chip creator hands it: observations
written by ``pandas.DataFrame.to_parquet`` (pyarrow, Snappy, dictionary
pages), with a ``time`` column, a null (in ``note``) and a ``list<double>``
column. The expected records are the rows the frame was built from, as JSON
(datetimes as ``str``); ``chip_smoke.py`` and
``tests/test_torch_parquet.py::test_fixture_reads_equal_to_its_json`` read
the file through ``instageo_tpu_torch.data.parquet.read_table`` and hold it
to them. Needs pandas and pyarrow:

    python tools/gen_torch_parquet_fixture.py
"""

from __future__ import annotations

import json
import os
from datetime import datetime, timedelta

import numpy as np
import pandas as pd

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests",
                   "torch_fixtures", "observations")


def rows(n: int = 24, seed: int = 16) -> list:
    rng = np.random.default_rng(seed)
    day = datetime(2022, 5, 25)
    out = []
    for i in range(n):
        x, y = 14.99 + float(rng.uniform(0, 0.02)), 43.0 + float(rng.uniform(0, 0.02))
        out.append({
            "x": x, "y": y, "label": int(rng.integers(0, 2)),
            "date": day + timedelta(days=int(i % 3)),
            "time": ("10:30:00", "10:45:30", "11:00:00")[i % 3],
            "bbox": [x - 0.001, y - 0.001, x + 0.001, y + 0.001],
            "note": None if i % 5 == 2 else ("field", "edge", "road")[i % 3],
        })
    return out


def main() -> None:
    data = rows()
    pd.DataFrame(data).to_parquet(OUT + ".parquet", compression="snappy")
    with open(OUT + ".json", "w") as f:
        json.dump(data, f, default=str, indent=1)
        f.write("\n")
    print(f"wrote {OUT}.parquet ({os.path.getsize(OUT + '.parquet')} bytes) and .json")


if __name__ == "__main__":
    main()
