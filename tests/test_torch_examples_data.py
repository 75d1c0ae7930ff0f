"""The port's data walkthroughs against the JAX ones, run as a user runs them.

Each demo of ``instageo_tpu_torch/examples/`` runs in a fresh interpreter
(``python -m ... <root> --device cpu``) after its JAX twin of ``examples/``
ran in another one (``tests/data_tests/test_example_demos.py``'s way) in the
same directory: the port's run prints the JAX demo's marker, and every file
it writes equals the JAX run's byte for byte (absolute paths inside the
files included, hence the one directory), but the chip creators'
filtered-records caches: Parquet in both, written by different writers
(pandas there, ``data/parquet.py`` here), they are held equal as the
DataFrames ``pd.read_parquet`` gives. The US CDL records utility of
``instageo_tpu_torch/experiments/utils/`` likewise against its twin.
"""

import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_JAX_BOOT = (
    "import jax; jax.config.update('jax_platforms', 'cpu'); "
    "import runpy, sys; script, out = sys.argv[1], sys.argv[2]; "
    "sys.argv = [script, out]; runpy.run_path(script, run_name='__main__')"
)
RECORDS_CACHE = ("filtered_obsv_records", "filtered_raster_records")


def _run(argv, timeout=300):
    # Both pipelines' thread pools can load one tile several times at once
    # (their tile cache checks, then loads); at 30 asset loads a minute that
    # stalls a run for up to 60 s, so the limit is raised for both.
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
           "INSTAGEO_COG_RATELIMIT": "1000"}
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=timeout, cwd=REPO,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Traceback" not in proc.stdout
    return proc.stdout


def _tree(root):
    """Relative path -> sha256 of every file under ``root`` but the
    records caches."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.startswith(RECORDS_CACHE):
                continue
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


@pytest.mark.parametrize("name,marker,device", [
    ("chip_creator_demo", "cloud-masked corner is no-data: True", True),
    ("raster_chip_creator_demo", "2 chips + 2 seg maps", True),
    ("data_cleaner_demo", "labeled pixels per seg map after limiting", True),
    ("data_splitter_demo", "splits_locations.png", False),
])
def test_demo_equals_the_jax_demo(name, marker, device, tmp_path):
    out = tmp_path / "out"
    jax_stdout = _run([sys.executable, "-c", _JAX_BOOT,
                       os.path.join(REPO, "examples", f"{name}.py"), str(out)])
    assert marker in jax_stdout
    jax_files = _tree(out)
    shutil.move(str(out), str(tmp_path / "jax"))
    stdout = _run([sys.executable, "-m", f"instageo_tpu_torch.examples.{name}", str(out)]
                  + (["--device", "cpu"] if device else []))
    assert marker in stdout, stdout
    files = _tree(out)
    assert sorted(files) == sorted(jax_files)
    assert [f for f in files if files[f] != jax_files[f]] == []
    caches = [os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out)
              for f in fs if f.startswith(RECORDS_CACHE)]
    assert all(f.endswith(".parquet") for f in caches)
    assert caches or name == "data_splitter_demo"
    for rel in caches:
        pd.testing.assert_frame_equal(pd.read_parquet(os.path.join(out, rel)),
                                      pd.read_parquet(os.path.join(tmp_path, "jax", rel)),
                                      check_exact=True, obj=rel)


def test_demo_without_a_card_refuses_cuda(tmp_path):
    """``--device`` is ``cuda`` by default: without a card the chip creator
    raises before any chip is written."""
    proc = subprocess.run(
        [sys.executable, "-m", "instageo_tpu_torch.examples.raster_chip_creator_demo",
         str(tmp_path / "out")], capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert not (tmp_path / "out" / "out_raster" / "chips").exists()


def test_us_cdl_records_utility_equals_jax(tmp_path):
    from instageo_tpu_torch.data.geotiff import Affine, GeoTiffReader, write_geotiff
    from instageo_tpu_torch.data.table import read_csv

    cdl = np.zeros((96, 96), np.uint8)
    cdl[:40, :40] = 5   # one crop region
    cdl[60:, 60:] = 24  # another
    raster = tmp_path / "cdl.tif"
    write_geotiff(str(raster), cdl[None], transform=Affine.from_origin(500000, 4500000, 30, 30),
                  crs=32633, nodata=0)
    args = ["--raster-path", str(raster), "--records-file", str(tmp_path / "out" / "records.csv"),
            "--date", "2024-09-01", "--output-path", str(tmp_path / "out" / "labels"),
            "--window-size", "48"]
    os.makedirs(tmp_path / "out")
    _run([sys.executable, os.path.join(REPO, "experiments", "utils",
                                       "create_us_cdl_records.py")] + args)
    jax_files = _tree(tmp_path / "out")
    shutil.move(str(tmp_path / "out"), str(tmp_path / "jax"))
    os.makedirs(tmp_path / "out")
    stdout = _run([sys.executable, os.path.join(REPO, "instageo_tpu_torch", "experiments",
                                                "utils", "create_us_cdl_records.py")] + args)
    assert "Wrote 2 label windows" in stdout
    assert _tree(tmp_path / "out") == jax_files
    rows, _ = read_csv(str(tmp_path / "out" / "records.csv"))
    assert sorted(r["label_filename"] for r in rows) == ["cdl_window_0_0.tif",
                                                        "cdl_window_48_48.tif"]
    with GeoTiffReader(str(tmp_path / "out" / "labels" / "cdl_window_48_48.tif")) as r:
        assert (r.read(1)[12:, 12:] == 24).all()
        assert r.transform * (0, 0) == (500000 + 48 * 30, 4500000 - 48 * 30)
