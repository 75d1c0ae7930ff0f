"""The port's data-preparation modules against the JAX package's.

* the data cleaner and the data splitter CLIs: the same seeded worlds through
  the JAX functions and the port's CLIs; every file written is equal (CSV
  rows with paths taken relative to each side's directory, seg maps array,
  dtype, transform, CRS and nodata bit for bit, the split map's PNG byte for
  byte);
* the splitter's numpy KMeans, scaler and split against scikit-learn:
  labels and splits equal, centroids within 1e-12 (the centre sums are
  taken in another order);
* the JP2 opener through ``libopenjp2`` against ``cv2.imread`` and a
  committed fixture, and its refusal without the library;
* the regression plot, the compile-cache root and the registry sync script
  (under a stub ``gsutil``) against the JAX package's.
"""

import csv
import os
import stat
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from instageo_tpu.data import data_cleaner as jax_cleaner
from instageo_tpu.data import data_splitter as jax_splitter
from instageo_tpu.data import downloads as jax_downloads
from instageo_tpu.data.geotiff import GeoTiffReader as JaxGeoTiffReader
from instageo_tpu_torch.data import data_cleaner, data_splitter, downloads, jp2
from instageo_tpu_torch.data.crs import utm_to_latlon
from instageo_tpu_torch.data.geotiff import Affine, write_geotiff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures")
EPSG = 32633
ORIGIN = (499980.0, 4100040.0)
SIZE = 16


def _tree(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def _csv(path, root):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return [[os.path.relpath(v, root) if os.path.isabs(v) else v for v in r] for r in rows]


def assert_same_dirs(jdir, pdir):
    assert _tree(jdir) == _tree(pdir)
    for rel in _tree(jdir):
        a, b = os.path.join(jdir, rel), os.path.join(pdir, rel)
        if rel.endswith(".tif"):
            with JaxGeoTiffReader(a) as ra, JaxGeoTiffReader(b) as rb:
                xa, xb = ra.read(), rb.read()
                assert xa.dtype == xb.dtype and np.array_equal(xa, xb), rel
                assert ra.transform.to_gdal() == rb.transform.to_gdal(), rel
                assert (ra.crs, ra.nodata) == (rb.crs, rb.nodata), rel
        elif rel.endswith(".csv"):
            assert _csv(a, jdir) == _csv(b, pdir), rel
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
    return _tree(jdir)


# ---------------------------------------------------------------------------
# The data cleaner
# ---------------------------------------------------------------------------


def _world(root):
    """Four 16 px chips (6 bands, int16, no-data -9999 over a share of rows:
    0, 0.9, and the third with one band only) and seg maps named as the chip
    creator names them (MGRS tile 33SWA), with labels whose windows overlap;
    a points CSV over two of them (one point off the chips)."""
    rng = np.random.default_rng(11)
    rows, points = [], []
    shares = [0.0, 0.9, 0.6, 0.25]
    for i, share in enumerate(shares):
        x0, y0 = ORIGIN[0] + i * SIZE * 30.0, ORIGIN[1]
        tr = Affine.from_origin(x0, y0, 30.0, 30.0)
        chip = rng.integers(1, 100, (6, SIZE, SIZE)).astype(np.int16)
        bad = int(share * SIZE)
        if i == 2:
            chip[0, :bad] = -9999  # one band: dropped by "any" only
        elif bad:
            chip[:, :bad] = -9999
        seg = np.full((SIZE, SIZE), -1, np.int16)
        for r, c, v in ((8, 8, 1), (8, 9, 2), (2, 3, 0), (15, 0, 1), (9, 9, 0)):
            seg[r, c] = v
        date = "20220525" if i % 2 == 0 else "20220610"
        name = f"{date}_HLS_S30_T33SWA_{i}_0"
        chip_path = os.path.join(root, "chips", f"chip_{name}.tif")
        seg_path = os.path.join(root, "seg_maps", f"seg_map_{name}.tif")
        os.makedirs(os.path.dirname(chip_path), exist_ok=True)
        os.makedirs(os.path.dirname(seg_path), exist_ok=True)
        write_geotiff(chip_path, chip, transform=tr, crs=EPSG, nodata=-9999)
        write_geotiff(seg_path, seg[None], transform=tr, crs=EPSG, nodata=-1)
        rows.append({"Input": chip_path, "Label": seg_path, "extra": i * 0.5})
        if i in (0, 3):
            for r, c in ((4, 5), (10, 12)):
                lat, lon = utm_to_latlon(x0 + (c + 0.5) * 30.0, y0 - (r + 0.5) * 30.0, 33, False)
                points.append({"x": float(lon), "y": float(lat), "date": "2022-05-25"})
    lat, lon = utm_to_latlon(ORIGIN[0] - 3000.0, ORIGIN[1], 33, False)
    points.append({"x": float(lon), "y": float(lat), "date": "2022-05-25"})
    pd.DataFrame(rows).to_csv(os.path.join(root, "dataset.csv"), index=False)
    pd.DataFrame(points).to_csv(os.path.join(root, "points.csv"), index=False)
    tiled = pd.DataFrame(points).assign(mgrs_tile_id="33SWA")
    tiled.to_csv(os.path.join(root, "points_tiled.csv"), index=False)


CLEANER_CASES = {
    "drop_any": dict(drop_chips=True),
    "drop_all_threshold": dict(drop_chips=True, drop_chips_strategy="all",
                               no_data_threshold=0.2),
    "buffer_w1": dict(clean_seg_maps=True, cleaning_method="buffer", window_size=1),
    "drop_and_buffer_w2": dict(drop_chips=True, clean_seg_maps=True, cleaning_method="buffer",
                               window_size=2),
    "limit": dict(clean_seg_maps=True, cleaning_method="limit",
                  observation_points_csv="points.csv"),
    "limit_tiled": dict(clean_seg_maps=True, cleaning_method="limit",
                        observation_points_csv="points_tiled.csv"),
}


def _flag_args(kw):
    out = []
    for k, v in kw.items():
        if isinstance(v, bool):
            out.append(f"--{k}" if v else f"--no{k}")
        else:
            out.append(f"--{k}={v}")
    return out


@pytest.mark.parametrize("case", sorted(CLEANER_CASES))
def test_data_cleaner_equals_jax(tmp_path, case):
    spec = dict(CLEANER_CASES[case])
    outs = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        root.mkdir()
        _world(str(root))
        kw = dict(spec)
        if "observation_points_csv" in kw:
            kw["observation_points_csv"] = str(root / kw["observation_points_csv"])
        out = root / "out"
        out.mkdir()
        kw["seg_map_output_dir"] = str(out / "seg_maps")
        if side == "jax":
            jax_cleaner.clean_data(str(root / "dataset.csv"), str(out / "clean.csv"), **kw)
        else:
            data_cleaner.main([f"--chips_dataset_csv={root / 'dataset.csv'}",
                               f"--output_chips_dataset_csv={out / 'clean.csv'}"]
                              + _flag_args(kw))
        outs[side] = (str(root), str(out))
    (jroot, jout), (proot, pout) = outs["jax"], outs["port"]
    assert _csv(os.path.join(jout, "clean.csv"), jroot) == _csv(os.path.join(pout, "clean.csv"),
                                                                proot)
    files = assert_same_dirs(jout, pout)
    with open(os.path.join(pout, "clean.csv")) as f:
        n_rows = len(f.read().splitlines()) - 1
    if spec.get("drop_chips"):
        assert n_rows < 4
    if spec.get("clean_seg_maps"):
        assert len([f for f in files if f.startswith("seg_maps/")]) == n_rows > 0


# ---------------------------------------------------------------------------
# The data splitter
# ---------------------------------------------------------------------------


TILES = ["T33TUN", "T33TUM", "T33TVN", "T17TPJ", "T17TPK", "T56HLH", "T56HLG", "T31UDQ",
         "T10SEG", "T36MZE"]


def _split_rows(kind, n=120):
    rng = np.random.default_rng(7)
    rows = []
    for i in range(n):
        tile = TILES[int(rng.integers(0, len(TILES)))]
        year = 2016 + int(rng.integers(0, 7))
        if kind == "tiles":
            name = f"chip_{year}0101_S30_{tile}_{i}_0.tif"
        elif kind == "years":
            name = f"chip_{year}-05-01_sample-{i}.tif"
        else:
            name = f"chip_sample-{i}.tif"
        rows.append({"Input": f"chips/{name}", "Label": f"seg_maps/seg_{name}",
                     "weight": round(float(rng.uniform(0, 1)), 3)})
    return rows


SPLITTER_CASES = {
    "kmeans": ("tiles", dict(n_clusters=5)),
    "kmeans_default_clusters_visualized": ("tiles", dict(visualize=True)),
    "kmeans_no_val": ("tiles", dict(n_clusters=4, include_val=False, random_state=3)),
    "mgrs_groups": ("tiles", dict(use_kmeans=False)),
    "mgrs_groups_no_overlap": ("tiles", dict(use_kmeans=False, allow_group_overlap=False,
                                             distance_threshold=900.0)),
    "year_groups": ("years", dict()),
    "year_groups_no_test": ("years", dict(include_test=False, random_state=5)),
    "random": ("none", dict(test_ratio=0.25, val_ratio=0.15)),
    "random_no_test": ("none", dict(include_test=False, random_state=9)),
}


@pytest.mark.parametrize("case", sorted(SPLITTER_CASES))
def test_data_splitter_equals_jax(tmp_path, case):
    kind, kw = SPLITTER_CASES[case]
    args = dict(val_ratio=0.2, test_ratio=0.2, visualize=False, random_state=42)
    args.update(kw)
    rows = _split_rows(kind)
    src = tmp_path / "dataset.csv"
    pd.DataFrame(rows).to_csv(src, index=False)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jargs = {k: v for k, v in args.items() if k != "visualize"}
    jax_splitter.split_dataset(pd.read_csv(src), output_dir=str(jdir),
                               save_viz=args["visualize"], **jargs)
    data_splitter.main([f"--input_file={src}", f"--output_dir={pdir}"] + _flag_args(args))
    files = assert_same_dirs(str(jdir), str(pdir))
    assert ("splits_locations.png" in files) == args["visualize"]
    counts = {}
    for name in ("train", "val", "test"):
        if f"{name}.csv" in files:
            counts[name] = len(pd.read_csv(pdir / f"{name}.csv"))
    assert counts["train"] > 0
    assert all(c in files for c in ["train.csv"])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kmeans_scaler_split_equal_sklearn(seed):
    from sklearn.cluster import KMeans
    from sklearn.model_selection import train_test_split
    from sklearn.preprocessing import StandardScaler

    rng = np.random.default_rng(seed)
    n = [37, 150, 400, 90][seed]
    if seed % 2:  # tile centres repeat: many points at few places
        places = rng.normal(size=(12, 2)) * [8.0, 30.0] + [35.0, -95.0]
        x = places[rng.integers(0, len(places), n)]
    else:
        x = rng.normal(size=(n, 2)) * [2.0, 9.0]
    x[:, 1] = x[:, 1] if seed != 2 else 3.25  # a constant feature keeps scale 1
    ref = StandardScaler().fit_transform(x)
    ours = data_splitter.standard_scale(x)
    np.testing.assert_array_equal(ours, ref)
    k = min(8, len(np.unique(x, axis=0)))
    km = KMeans(n_clusters=k, random_state=seed, n_init=10).fit(ref)
    labels, centers = data_splitter.kmeans(ours, k, seed)
    np.testing.assert_array_equal(labels, km.labels_)
    np.testing.assert_allclose(centers, km.cluster_centers_, rtol=0, atol=1e-12)
    rows = [{"i": i} for i in range(n)]
    train, test = data_splitter.train_test_split(rows, 0.3, seed)
    ref_train, ref_test = train_test_split(list(range(n)), test_size=0.3, random_state=seed)
    assert [r["i"] for r in train] == ref_train and [r["i"] for r in test] == ref_test


# ---------------------------------------------------------------------------
# JPEG 2000 through libopenjp2
# ---------------------------------------------------------------------------


def test_jp2_fixture_decodes_to_its_array_and_cv2s():
    import cv2

    path = os.path.join(FIXTURES, "s2_band.jp2")
    got = jp2.read_jp2(path)
    want = np.load(os.path.join(FIXTURES, "s2_band.npy"))
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_UNCHANGED))


def test_open_mf_jp2_dataset_equals_jax(tmp_path):
    import cv2

    rng = np.random.default_rng(4)
    files = {}
    for name, shape in (("B02", (70, 64)), ("B03", (64, 72)), ("B04", (66, 66))):
        p = str(tmp_path / f"{name}.jp2")
        assert cv2.imwrite(p, rng.integers(0, 12000, shape).astype(np.uint16))  # lossy
        files[name] = p
    scl = str(tmp_path / "SCL.jp2")
    assert cv2.imwrite(scl, rng.integers(0, 12, (64, 64)).astype(np.uint8),
                       [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000])
    bands, scl_arr = downloads.open_mf_jp2_dataset(files, scl)
    ref_bands, ref_scl = jax_downloads.open_mf_jp2_dataset(files, scl)
    assert bands.dtype == ref_bands.dtype and bands.shape == (3, 64, 64)
    np.testing.assert_array_equal(bands, ref_bands)
    np.testing.assert_array_equal(scl_arr, ref_scl)
    missing_scl = downloads.open_mf_jp2_dataset(files, str(tmp_path / "none.jp2"))[1]
    assert missing_scl is None is jax_downloads.open_mf_jp2_dataset(
        files, str(tmp_path / "none.jp2"))[1]
    (tmp_path / "not.jp2").write_bytes(b"not a jpeg 2000 file")
    with pytest.raises(IOError, match="Cannot decode JP2"):
        downloads.open_mf_jp2_dataset({"B02": str(tmp_path / "not.jp2")})


def test_jp2_without_libopenjp2_raises_naming_it(monkeypatch):
    import ctypes

    monkeypatch.setattr(jp2, "_lib", None)
    monkeypatch.setattr(jp2.ctypes.util, "find_library", lambda name: None)

    def no_lib(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(ctypes, "CDLL", no_lib)
    with pytest.raises(OSError, match="libopenjp2"):
        downloads.open_mf_jp2_dataset({"B02": os.path.join(FIXTURES, "s2_band.jp2")})


# ---------------------------------------------------------------------------
# The regression plot, the compile cache, the registry sync
# ---------------------------------------------------------------------------


def test_regression_plot_equals_jax(tmp_path):
    from instageo_tpu.train.plots import create_regression_plot as jax_plot
    from instageo_tpu_torch.train.plots import create_regression_plot

    rng = np.random.default_rng(8)
    labels = rng.uniform(0, 10, 500)
    preds = labels + rng.normal(0, 1, 500)
    metrics = {"test_RMSE": 1.0123, "test_R2": 0.9, "test_loss": 2.0, "steps": 3}
    ours = create_regression_plot(preds, labels, dict(metrics), str(tmp_path / "p" / "a.png"),
                                  "test")
    ref = jax_plot(preds, labels, dict(metrics), str(tmp_path / "j" / "a.png"), "test")
    with open(ours, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert create_regression_plot(np.zeros(0), np.zeros(0), {}, str(tmp_path / "e.png")) is None


def test_regression_plot_without_matplotlib_is_refused(monkeypatch):
    import builtins

    from instageo_tpu_torch.train import plots

    real_import = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="matplotlib"):
        plots.create_regression_plot(np.ones(3), np.ones(3), {}, "/nonexistent/x.png")


def test_compile_cache_root_is_honoured(tmp_path, monkeypatch):
    from instageo_tpu_torch import native
    from instageo_tpu_torch.ops import _build
    from instageo_tpu_torch.utils import compile_cache

    default = _build._lib_path("dropout")
    assert default.parent.parent == compile_cache.DEFAULT_ROOT
    monkeypatch.setenv("INSTAGEO_COMPILE_CACHE_DIR", str(tmp_path / "cache"))
    moved = _build._lib_path("dropout")
    assert moved == tmp_path / "cache" / default.parent.name / default.name  # same hash
    assert native.lib_path().parent.parent == tmp_path / "cache" / "native"
    # Opted out: each process has a root of its own, the same within it.
    code = ("from instageo_tpu_torch.utils.compile_cache import build_root; "
            "a = build_root(); print(a, a == build_root(), a.is_dir())")
    env = dict(os.environ, INSTAGEO_COMPILE_CACHE="0")
    outs = [subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=120, check=True).stdout.split()
            for _ in range(2)]
    assert outs[0][1:] == outs[1][1:] == ["True", "True"]
    assert outs[0][0] != outs[1][0] and str(compile_cache.DEFAULT_ROOT) not in outs[0][0]
    assert not os.path.exists(outs[0][0])  # removed when its process ended


GSUTIL_STUB = """#!/usr/bin/env bash
# gsutil stand-in: gs://<path> is $GSUTIL_ROOT/<path>.
set -euo pipefail
[ "$1" = "-m" ] && shift
local_path() { echo "$GSUTIL_ROOT/${1#gs://}"; }
case "$1" in
  cp) cp "$(local_path "$2")" "$3" ;;
  rsync) [ "$2" = "-r" ] || exit 2; mkdir -p "$4"; cp -R "$(local_path "$3")/." "$4/" ;;
  *) exit 2 ;;
esac
"""


def test_registry_sync_writes_the_jax_scripts_tree(tmp_path):
    bucket = tmp_path / "gcs" / "bucket"
    registry = {"models": {
        "flood_mapping": {"name": "Flood", "sizes": {
            "base": {"model_name": "prithvi_eo_v1_100",
                     "gcs_folder": "gs://bucket/models/flood/base"},
            "large": {"model_name": "prithvi_eo_v2_300"}}},
        "crop": {"name": "Crop: 13 classes", "sizes": {
            "base": {"gcs_folder": "gs://bucket/models/crop/base"}}},
        "locust": {"name": "Locust"}}}
    import yaml

    (bucket / "registry").mkdir(parents=True)
    (bucket / "registry" / "models_registry.yaml").write_text(yaml.safe_dump(registry))
    for folder, n in (("flood/base", 2), ("crop/base", 1)):
        d = bucket / "models" / folder
        (d / ".hydra").mkdir(parents=True)
        (d / ".hydra" / "config.yaml").write_text(f"model: {folder}\n")
        for i in range(n):
            (d / f"ckpt_{i}.bin").write_bytes(bytes(range(i, i + 40)))
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    stub = bin_dir / "gsutil"
    stub.write_text(GSUTIL_STUB)
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               GSUTIL_ROOT=str(tmp_path / "gcs"))
    trees = {}
    for side, script in (("jax", "instageo_tpu/serve/model_registry_sync.sh"),
                         ("port", "instageo_tpu_torch/serve/model_registry_sync.sh")):
        dest = tmp_path / f"models_{side}"
        proc = subprocess.run(["bash", os.path.join(ROOT, script),
                               "gs://bucket/registry/models_registry.yaml", str(dest)],
                              cwd=str(tmp_path), env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.splitlines()[-1] == f"Model registry synced to {dest}"
        trees[side] = str(dest)
    files = assert_same_dirs(trees["jax"], trees["port"])
    assert "flood_mapping/base/.hydra/config.yaml" in files
    assert "crop/base/ckpt_0.bin" in files and not any(f.startswith("locust") for f in files)
