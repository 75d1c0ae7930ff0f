"""The port's chip creators against the JAX package's, file for file.

The same seeded worlds (local granule GeoTIFFs of a 64 px tile, STAC items
of them, observation CSVs or label rasters, 32 px chips, as
``tests/data_tests/test_chip_creator_e2e.py`` uses) go through the JAX CLI
(absl ``FLAGS``, ``StacClient.search`` monkeypatched) and through the port's
CLI with ``--device=cpu``. Tolerance: every file written is equal: GeoTIFF
arrays, dtype, transform, CRS and nodata bit for bit; JSON equal; CSV rows
equal as sets (the raster manifest's absolute paths taken relative to each
output directory). The records cache is the one deliberate difference
(Parquet there, JSON here), so it is compared as records.

The STAC search and the asset loads are rate limited per process (10
searches and 30 loads a minute); these tests call the functions under the
limiters (their retries kept) so that the suite's other tests in the same
worker do not make them wait, and skip the search's one-second pause per
tile.
"""

import copy
import csv
import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest

from instageo_tpu.data import chip_creator as jax_cc
from instageo_tpu.data import downloads as jax_downloads
from instageo_tpu.data import raster_chip_creator as jax_rcc
from instageo_tpu.data import stac as jax_stac
from instageo_tpu.data.geotiff import GeoTiffReader as JaxGeoTiffReader
from instageo_tpu.data.sources import hls as jax_hls
from instageo_tpu.data.sources import s1 as jax_s1
from instageo_tpu.data.sources import s2 as jax_s2
from instageo_tpu_torch.data import chip_creator, downloads, raster_chip_creator, stac
from instageo_tpu_torch.data.crs import latlon_to_utm, utm_to_latlon
from instageo_tpu_torch.data.geotiff import Affine, write_geotiff
from instageo_tpu_torch.data.sources import hls, s1, s2
from instageo_tpu_torch.data.table import load_records

TILE = 64
CHIP = 32
RES = 30.0
EPSG = 32633


class _NoPause:
    @staticmethod
    def sleep(seconds):
        pass


@pytest.fixture(autouse=True)
def _unlimited(monkeypatch):
    """Both packages' searches and asset loads without their per-process
    rate limiters and pauses (the retries stay)."""
    monkeypatch.setattr(jax_stac, "time", _NoPause)
    monkeypatch.setattr(stac, "time", _NoPause)
    for mod in (jax_hls, jax_s2, jax_s1, hls, s2, s1):
        monkeypatch.setattr(mod, "retrieve_stac_metadata",
                            mod.retrieve_stac_metadata.__wrapped__)
    monkeypatch.setattr(jax_stac, "_load_asset", jax_stac._load_asset.__wrapped__)
    monkeypatch.setattr(stac, "_load_asset", stac._load_asset.__wrapped__)
    jax_cc.FLAGS.unparse_flags()
    yield
    jax_cc.FLAGS.unparse_flags()


def _search_returns(monkeypatch, item_dicts):
    """Both clients' search returns fresh items made from the same dicts."""
    monkeypatch.setattr(jax_stac.StacClient, "search", lambda self, **kw: [
        jax_stac.StacItem.from_dict(copy.deepcopy(d)) for d in item_dicts])
    monkeypatch.setattr(stac.StacClient, "search", lambda self, **kw: [
        stac.StacItem.from_dict(copy.deepcopy(d)) for d in item_dicts])


def _grid():
    e0, n0, zone, south = latlon_to_utm(43.0, 15.0)
    ox, oy = float(e0) - (TILE / 2) * RES, float(n0) + (TILE / 2) * RES
    return ox, oy, zone, south


def _lonlat(px, py):
    ox, oy, zone, south = _grid()
    lat, lon = utm_to_latlon(ox + px * RES, oy - py * RES, zone, south)
    return float(lon), float(lat)


SOURCES = {
    "HLS": dict(bands=["B02", "B03", "B04", "B8A", "B11", "B12"], mask="Fmask",
                dtype=np.uint16, collection="HLSS30_2.0",
                ids=lambda t, day: f"HLS.S30.T33TUN.2022{145 - 5 * t:03d}T100000.v2.0"),
    "S2": dict(bands=["B02", "B03", "B04", "B8A", "B11", "B12"], mask="SCL",
               dtype=np.uint16, collection="sentinel-2-l2a",
               ids=lambda t, day: f"S2B_MSIL2A_{day}T100000_N0510_R022_T33TUN_x"),
    "S1": dict(bands=["vv", "vh"], mask=None, dtype=np.float32, collection="sentinel-1-rtc",
               ids=lambda t, day: f"S1A_IW_GRDH_1SDV_{day}T100000_{day}T100025_054000_"
                                  f"069000_ABCD"),
}


def _granules(root, source, when, seed=0):
    """Local granule files of one 64 px tile for each timestamp in ``when``
    and their STAC item dicts."""
    spec = SOURCES[source]
    ox, oy, zone, south = _grid()
    tr = Affine.from_origin(ox, oy, RES, RES)
    rng = np.random.default_rng(seed)
    lat_a, lon_a = utm_to_latlon(ox, oy - TILE * RES, zone, south)
    lat_b, lon_b = utm_to_latlon(ox + TILE * RES, oy, zone, south)
    items = []
    for t, ts in enumerate(when):
        gid = spec["ids"](t, ts[:10].replace("-", ""))
        assets = {}
        for b in spec["bands"]:
            if spec["dtype"] == np.float32:
                arr = rng.uniform(0.0, 0.5, (TILE, TILE)).astype(np.float32)
            else:
                arr = rng.integers(100, 5000, (TILE, TILE)).astype(np.uint16)
            p = os.path.join(root, f"{gid}_{b}.tif")
            write_geotiff(p, arr[None], transform=tr, crs=EPSG, nodata=0)
            assets[b] = {"href": p}
        if spec["mask"]:
            if source == "HLS":  # cloud bit in the first chip's corner, shadow and water
                qa = rng.choice(np.asarray([0, 0, 0, 8, 32], np.uint16), (TILE, TILE))
                qa[:2, :2] = 2
            else:  # vegetation, cloud class 9 in the first chip's corner
                qa = np.full((TILE, TILE), 4, np.uint16)
                qa[:2, :2] = 9
            p = os.path.join(root, f"{gid}_{spec['mask']}.tif")
            write_geotiff(p, qa[None], transform=tr, crs=EPSG)
            assets[spec["mask"]] = {"href": p}
        items.append({"id": gid, "collection": spec["collection"],
                      "bbox": [float(lon_a), float(lat_a), float(lon_b), float(lat_b)],
                      "properties": {"datetime": ts, "eo:cloud_cover": 2 + t},
                      "assets": assets})
    return items


POINTS = [(5, 5, 1), (CHIP + 5, CHIP + 7, 0), (6, 8, 1), (CHIP + 20, 3, 1), (50, 40, 0)]


def _observations(path, date, time=None, labels=None, fmt="csv"):
    rows = []
    for i, (px, py, label) in enumerate(POINTS):
        lon, lat = _lonlat(px + 0.5, py + 0.5)
        row = {"x": lon, "y": lat, "label": label if labels is None else labels[i],
               "date": date}
        if time:
            row["time"] = time
        rows.append(row)
    df = pd.DataFrame(rows)
    if fmt == "parquet":
        df.to_parquet(path)
    else:
        df.to_csv(path, index=False)
    return path


def _run_both(tmp_path, module_pair, args, runs=2):
    """The JAX CLI and the port's (``--device=cpu``) with the same flags,
    each into its own output directory, ``runs`` times (the later runs
    resume). Returns the two directories."""
    jax_mod, port_mod = module_pair
    out = {}
    for side in ("jax", "port"):
        d = str(tmp_path / f"out_{side}")
        argv = args + [f"--output_directory={d}"]
        for _ in range(runs):
            if side == "jax":
                jax_mod.FLAGS.unparse_flags()
                jax_mod.FLAGS(["prog"] + argv)
                jax_mod.main(None)
            else:
                port_mod.main(argv + ["--device=cpu"])
        out[side] = d
    return out["jax"], out["port"]


def _csv_rows(path, root):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], {tuple(os.path.relpath(v, root) if os.path.isabs(v) else v
                           for v in r) for r in rows[1:]}


def assert_same_outputs(jax_dir, port_dir, index_column=False):
    """Every file of the two output directories equal (see the module's
    docstring); returns the relative paths compared."""
    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    jf = [f for f in files(jax_dir) if not f.endswith(".parquet")]
    pf = [f for f in files(port_dir) if not f.startswith("filtered_")]
    assert jf == pf
    for rel in jf:
        a, b = os.path.join(jax_dir, rel), os.path.join(port_dir, rel)
        if rel.endswith(".tif"):
            with JaxGeoTiffReader(a) as ra, JaxGeoTiffReader(b) as rb:
                xa, xb = ra.read(), rb.read()
                assert xa.dtype == xb.dtype and np.array_equal(xa, xb, equal_nan=True), rel
                assert ra.transform.to_gdal() == rb.transform.to_gdal(), rel
                assert (ra.crs, ra.nodata) == (rb.crs, rb.nodata), rel
        elif rel.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), rel
        elif rel.endswith(".csv"):
            ha, ra_ = _csv_rows(a, jax_dir)
            hb, rb_ = _csv_rows(b, port_dir)
            assert ha == hb and ra_ == rb_, rel
            if index_column:
                assert ha[0] == ""
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
    # The records cache: Parquet on the JAX side, JSON here.
    caches = [f for f in os.listdir(jax_dir) if f.endswith(".parquet")]
    for name in caches:
        jrec = pd.read_parquet(os.path.join(jax_dir, name)).to_dict("records")
        prec = load_records(os.path.join(port_dir, name.replace(".parquet", ".json")))
        assert len(jrec) == len(prec)
        for j, p in zip(jrec, prec):
            assert set(j) == set(p)
            for k in j:
                jv = j[k].to_pydatetime() if isinstance(j[k], pd.Timestamp) else j[k]
                jv = list(jv) if isinstance(jv, np.ndarray) else jv
                pv = list(p[k]) if isinstance(p[k], (list, tuple)) else p[k]
                assert jv == pv, (name, k)
    return jf


CASES = {
    # The JAX e2e test's flags (one granule, cloud masking, a 3x3 window),
    # and the daytime filter.
    "hls_points_cloud": dict(
        source="HLS", when=["2022-05-25T10:00:00Z"], date="2022-05-25",
        args=["--data_source=HLS", "--chip_size=32", "--min_count=1",
              "--shift_to_month_start=false", "--is_time_series_task=false",
              "--mask_types=cloud", "--masking_strategy=any", "--window_size=1",
              "--temporal_tolerance=5", "--daytime_only"]),
    # Three timesteps: a time column, the month-start shift, absl spellings.
    "hls_series_time_month_start": dict(
        source="HLS", date="2022-06-16", time="10:30:00",
        when=["2022-05-27T10:00:00Z", "2022-05-22T10:00:00Z", "2022-05-17T10:00:00Z"],
        args=["--data_source", "HLS", "--chip_size=32", "--min_count", "1",
              "--shift_to_month_start", "--temporal_step=5", "--num_steps=3",
              "--temporal_tolerance=2", "--mask_types=cloud,cloud_shadow",
              "--masking_strategy=each", "--nodaytime_only"]),
    "s2_points_scl": dict(
        source="S2", when=["2024-05-30T10:00:00Z"], date="2024-05-30",
        args=["--data_source=S2", "--chip_size=32", "--min_count=1",
              "--noshift_to_month_start", "--is_time_series_task=false",
              "--mask_types=cloud", "--masking_strategy=any"]),
    "s1_points_float32_reg": dict(
        source="S1", when=["2024-05-30T10:00:00Z"], date="2024-05-30",
        labels=[0.25, 1.5, 2.0, 0.75, 3.25],
        args=["--data_source=S1", "--chip_size=32", "--min_count=1",
              "--shift_to_month_start=false", "--is_time_series_task=false",
              "--task_type=reg", "--window_size=2"]),
    "hls_parquet_filters": dict(
        source="HLS", when=["2022-05-25T10:00:00Z"], date="2022-05-25", fmt="parquet",
        args=["--data_source=HLS", "--data_format=parquet", "--filters=label:==:1",
              "--chip_size=32", "--min_count=1", "--shift_to_month_start=false",
              "--is_time_series_task=false"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_point_chip_creator_equals_jax(tmp_path, monkeypatch, case):
    spec = CASES[case]
    items = _granules(str(tmp_path), spec["source"], spec["when"])
    _search_returns(monkeypatch, items)
    fmt = spec.get("fmt", "csv")
    obs = _observations(str(tmp_path / f"obs.{fmt}"), spec["date"], spec.get("time"),
                        spec.get("labels"), fmt)
    jdir, pdir = _run_both(tmp_path, (jax_cc, chip_creator),
                           spec["args"] + [f"--dataframe_path={obs}"])
    files = assert_same_outputs(jdir, pdir)
    chips = [f for f in files if f.startswith("chips/")]
    assert chips and len(chips) == len([f for f in files if f.startswith("seg_maps/")])
    with open(os.path.join(pdir, f"{spec['source'].lower()}_dataset.csv")) as f:
        assert len(f.read().splitlines()) == len(chips) + 1


def _s2_world(tmp_path, monkeypatch):
    items = _granules(str(tmp_path), "S2", ["2024-05-30T10:00:00Z"])
    _search_returns(monkeypatch, items)
    obs = [{"x": _lonlat(px + 0.5, py + 0.5)[0], "y": _lonlat(px + 0.5, py + 0.5)[1],
            "label": lab} for px, py, lab in POINTS]
    return obs


def test_failed_tile_is_retried_on_resume_as_jax(tmp_path, monkeypatch):
    """A tile whose load fails stays unmarked; the next run retries it and
    merges the manifest (the JAX package's resume contract)."""
    obs = _s2_world(tmp_path, monkeypatch)
    jdf = pd.DataFrame(obs).assign(date=pd.Timestamp("2024-05-30"),
                                   input_features_date=pd.Timestamp("2024-05-30"))
    from instageo_tpu.data.pipeline import get_tiles as jax_get_tiles
    from instageo_tpu_torch.data.pipeline import get_tiles
    from instageo_tpu_torch.data.table import group_by

    jrec, jds = jax_stac.create_records_with_items(
        jax_s2.add_s2_stac_items(jax_s2.get_client(), jax_get_tiles(jdf, min_count=1),
                                 num_steps=1, temporal_tolerance=5), "s2_granules", "s2_items")
    from datetime import datetime

    day = datetime(2024, 5, 30)
    prec, pds = stac.create_records_with_items(
        s2.add_s2_stac_items(s2.get_client(),
                             get_tiles([{**o, "date": day, "input_features_date": day}
                                        for o in obs], min_count=1),
                             num_steps=1, temporal_tolerance=5), "s2_granules", "s2_items")
    assert jds == pds
    kw = dict(chip_size=CHIP, src_crs=4326, mask_types=["cloud"], masking_strategy="any",
              window_size=0, task_type="seg")
    jpipe = jax_s2.S2PointsPipeline(output_directory=str(tmp_path / "out_jax"), **kw)
    ppipe = s2.S2PointsPipeline(output_directory=str(tmp_path / "out_port"), device="cpu",
                                **kw)
    jgroups = {k: g for k, g in jrec.groupby("stac_items_str")}
    pgroups = group_by(prec, "stac_items_str")
    with monkeypatch.context() as m:  # a transient failure: load_tile gives None
        m.setattr(jax_s2.S2PointsPipeline, "load_tile", lambda self, key, ds: None)
        m.setattr(s2.S2PointsPipeline, "load_tile", lambda self, key, ds: None)
        assert len(jpipe.run(jds, jgroups)) == 0 and len(ppipe.run(pds, pgroups)) == 0
    assert_same_outputs(str(tmp_path / "out_jax"), str(tmp_path / "out_port"))
    assert not os.path.exists(tmp_path / "out_port" / "processed_tiles.json")
    assert len(jpipe.run(jds, jgroups)) == len(ppipe.run(pds, pgroups)) > 0
    files = assert_same_outputs(str(tmp_path / "out_jax"), str(tmp_path / "out_port"))
    assert "processed_tiles.json" in files


def test_download_mode_equals_jax(tmp_path, monkeypatch):
    """``--processing_method=download-only`` then ``download`` over http
    hrefs, with ``parallel_download`` replaced by a copy from the local
    files in both packages: the same granules, dataset JSON (remote hrefs
    kept) and chips."""
    items = _granules(str(tmp_path), "HLS", ["2022-05-25T10:00:00Z"])
    local = {}
    for it in items:
        for name, a in it["assets"].items():
            url = f"http://granules.invalid/{os.path.basename(a['href'])}"
            local[url], a["href"] = a["href"], url
    _search_returns(monkeypatch, items)

    def fake_parallel_download(urls, outdir, headers=None, **kw):
        os.makedirs(outdir, exist_ok=True)
        done = []
        for name, url in urls.items():
            shutil.copy(local[url], os.path.join(outdir, name))
            done.append(os.path.join(outdir, name))
        return done

    monkeypatch.setattr(jax_downloads, "parallel_download", fake_parallel_download)
    monkeypatch.setattr(downloads, "parallel_download", fake_parallel_download)
    obs = _observations(str(tmp_path / "obs.csv"), "2022-05-25")
    common = ["--data_source=HLS", "--chip_size=32", "--min_count=1",
              "--shift_to_month_start=false", "--is_time_series_task=false",
              "--mask_types=cloud", f"--dataframe_path={obs}"]
    jdir, pdir = _run_both(tmp_path, (jax_cc, chip_creator),
                           common + ["--processing_method=download-only"], runs=1)
    files = assert_same_outputs(jdir, pdir)
    assert len([f for f in files if f.startswith("granules/")]) == 7
    assert not any(f.startswith("chips/") for f in files)
    with open(os.path.join(pdir, "hls_dataset.json")) as f:
        ds = json.load(f)
    assert all(a["href"].startswith("http://") for e in ds.values() for g in e["granules"]
               for a in g["assets"].values())
    jdir, pdir = _run_both(tmp_path, (jax_cc, chip_creator),
                           common + ["--processing_method=download"], runs=1)
    files = assert_same_outputs(jdir, pdir)
    assert len([f for f in files if f.startswith("chips/")]) == 3


def _label_rasters(root):
    """Two 32 px int16 label rasters inside the tile (UTM 33N) and their
    records CSV."""
    ox, oy, _, _ = _grid()
    rng = np.random.default_rng(5)
    rows = []
    for i, (c, r) in enumerate([(4, 6), (30, 28)]):
        lab = rng.integers(-1, 3, (1, CHIP, CHIP)).astype(np.int16)
        name = f"mask_{i}.tif"
        write_geotiff(os.path.join(root, name), lab,
                      transform=Affine.from_origin(ox + c * RES, oy - r * RES, RES, RES),
                      crs=EPSG, nodata=-1)
        rows.append({"label_filename": name, "date": "2022-05-25"})
    path = os.path.join(root, "records.csv")
    pd.DataFrame(rows).to_csv(path, index=False)
    return path


@pytest.mark.parametrize("variant", ["records_file", "records_file_utm", "bbox_feature"])
def test_raster_chip_creator_equals_jax(tmp_path, monkeypatch, variant):
    items = _granules(str(tmp_path), "HLS", ["2022-05-25T10:00:00Z"])
    _search_returns(monkeypatch, items)
    args = ["--data_source=HLS", "--chip_size=32", "--num_steps=1", "--mask_types=cloud",
            "--temporal_tolerance=3"]
    if variant == "bbox_feature":
        lo_lon, lo_lat = _lonlat(2, 60)
        hi_lon, hi_lat = _lonlat(60, 2)
        bbox_path = tmp_path / "bounding_boxes.json"
        bbox_path.write_text(json.dumps({"bboxes": [[lo_lon, lo_lat, hi_lon, hi_lat]]}))
        # The web backend's spellings.
        args += ["--is_bbox_feature=true", f"--bbox_feature_path={bbox_path}",
                 "--date=2022-05-25", "--spatial_resolution=0.0002694945852358564"]
    else:
        args += [f"--records_file={_label_rasters(str(tmp_path))}",
                 f"--raster_path={tmp_path}"]
        if variant == "records_file_utm":
            args += [f"--src_crs={EPSG}", "--masking_strategy=any", "--task_type=reg"]
    jdir, pdir = _run_both(tmp_path, (jax_rcc, raster_chip_creator), args)
    files = assert_same_outputs(jdir, pdir, index_column=True)
    chips = [f for f in files if f.startswith("chips/")]
    assert chips
    labels = [f for f in files if f.startswith("seg_maps/")]
    assert len(labels) == (0 if variant == "bbox_feature" else len(chips))


def test_cli_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    """``--device`` is ``cuda`` by default: without a card both CLIs raise
    before any work; nothing falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (chip_creator.main, raster_chip_creator.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([f"--dataframe_path={tmp_path}/missing.csv",
                  f"--output_directory={tmp_path}/out"])
    assert not os.path.exists(tmp_path / "out")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hls.HLSPointsPipeline(output_directory=str(tmp_path / "out"))


def test_parquet_input_needs_pyarrow(tmp_path, monkeypatch):
    """Without pyarrow, Parquet input is refused with an error naming it."""
    import builtins

    real_import = builtins.__import__

    def no_pyarrow(name, *a, **k):
        if name.split(".")[0] == "pyarrow":
            raise ImportError("No module named 'pyarrow'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(ImportError, match="pyarrow"):
        chip_creator.read_observations(str(tmp_path / "obs.parquet"), "parquet", [])
