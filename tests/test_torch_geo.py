"""The port's CRS, geo, STAC-selection, table and flag code against the JAX
package's, on seeded inputs.

Tolerance: equal. The CRS math is a copy expression for expression, so
coordinates are compared bit for bit (``np.array_equal``); bboxes, MGRS
codes, tile windows, grid records, item selections and dataset maps are
compared as values; the port's records against the JAX DataFrames' rows.
The table helpers are held against pandas itself (``to_csv`` bytes,
``read_csv`` types, ``groupby``, ``drop_duplicates``, ``explode``), the flag
parser against absl's ``FLAGS`` on each of absl's spellings, and the
``urllib`` clients (the STAC search with pagination, the downloads) against
a local HTTP server and, for the search, against the JAX client on the same
server.
"""

import copy
import functools
import http.server
import json
import os
import threading
from datetime import datetime, timezone

import numpy as np
import pandas as pd
import pytest

from instageo_tpu.data import crs as jax_crs
from instageo_tpu.data import flags as jax_flags
from instageo_tpu.data import geo_utils as jax_geo
from instageo_tpu.data import pipeline as jax_pipeline
from instageo_tpu.data import raster_chip_creator as jax_rcc
from instageo_tpu.data import stac as jax_stac
from instageo_tpu.data.geotiff import Affine as JaxAffine
from instageo_tpu_torch.data import crs, downloads, flags, geo_utils, pipeline, stac, table
from instageo_tpu_torch.data.geotiff import Affine

RNG = np.random.default_rng(20240530)
LATS = np.concatenate([RNG.uniform(-79.9, 83.9, 300), [0.0, 43.0, -33.9, 59.9, 72.5, 83.5]])
LONS = np.concatenate([RNG.uniform(-180.0, 179.999, 300), [0.0, 15.0, 151.2, 5.3, 10.0, 25.0]])


# ---------------------------------------------------------------------------
# crs: bit for bit
# ---------------------------------------------------------------------------


def test_utm_forward_and_inverse_bit_for_bit():
    for lat, lon in zip(LATS, LONS):
        got = crs.latlon_to_utm(lat, lon)
        want = jax_crs.latlon_to_utm(lat, lon)
        assert got[2:] == want[2:]
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        back = crs.utm_to_latlon(got[0], got[1], got[2], got[3])
        jback = jax_crs.utm_to_latlon(want[0], want[1], want[2], want[3])
        assert np.array_equal(back[0], jback[0]) and np.array_equal(back[1], jback[1])
    assert crs.utm_epsg(43.0, 15.0) == jax_crs.utm_epsg(43.0, 15.0) == 32633
    assert crs.utm_zone(60.0, 5.0) == jax_crs.utm_zone(60.0, 5.0) == 32


@pytest.mark.parametrize("src,dst", [(4326, 32633), (32633, 4326), (32633, 32634),
                                     (4326, 32733), ("EPSG:4326", "epsg:32633"),
                                     (32633, 32633)])
def test_transformer_bit_for_bit(src, dst):
    band = (np.abs(LATS) < 60) & (np.abs(LONS - 15) < 8)
    lon, lat = LONS[band], LATS[band]
    if str(src).upper().endswith("4326"):
        x, y = lon, np.abs(lat) if str(dst).endswith("326") else -np.abs(lat)
    else:
        x, y = crs.latlon_to_utm(np.abs(lat), lon, zone=33, south=False)[:2]
    got = crs.Transformer.from_crs(src, dst, always_xy=True).transform(x, y)
    want = jax_crs.Transformer.from_crs(src, dst, always_xy=True).transform(x, y)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("precision", [0, 1, 3, 5])
def test_mgrs_bit_for_bit(precision):
    ok = (LATS > -80) & (LATS < 84)
    for lat, lon in zip(LATS[ok], LONS[ok]):
        code = crs.to_mgrs(lat, lon, precision)
        assert code == jax_crs.to_mgrs(lat, lon, precision)
        assert crs.mgrs_to_utm(code) == jax_crs.mgrs_to_utm(code)
        assert crs.mgrs_to_latlon(code) == jax_crs.mgrs_to_latlon(code)


def test_haversine_bit_for_bit():
    got = crs.haversine_km(LATS[:-1], LONS[:-1], LATS[1:], LONS[1:])
    assert np.array_equal(got, jax_crs.haversine_km(LATS[:-1], LONS[:-1], LATS[1:], LONS[1:]))


# ---------------------------------------------------------------------------
# geo_utils
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bbox", [(2.0, 1.0, 1.0, 3.0), (1.0, 1.0, 1.0, 3.0),
                                  (5.0, 2.0, 5.0, 2.0), (14.9, 42.9, 15.1, 43.1),
                                  (11.5, 43.0, 12.5, 43.01), (-0.2, -0.1, 0.3, 0.2)])
def test_bbox_helpers_equal_jax(bbox):
    assert geo_utils.make_valid_bbox(*bbox) == jax_geo.make_valid_bbox(*bbox)
    valid = geo_utils.make_valid_bbox(*bbox)
    assert geo_utils.get_polygon_tile_ids(valid) == jax_geo.get_polygon_tile_ids(valid)
    other = (valid[0] + 0.05, valid[1] - 0.05, valid[2] + 1, valid[3] - 0.01)
    for a, b in ((valid, other), (other, valid), (valid, (50, 50, 51, 51))):
        assert geo_utils.bbox_intersects(a, b) == jax_geo.bbox_intersects(a, b)
        assert geo_utils.bbox_contains(a, b) == jax_geo.bbox_contains(a, b)
    for x, y in ((valid[0], valid[1]), (valid[2] + 1e-9, valid[3]), (0.0, 0.0)):
        assert geo_utils.point_within(valid, x, y) == jax_geo.point_within(valid, x, y)


@pytest.mark.parametrize("bbox,chip_size,crs_in", [
    ((8, 40, 40, 8), 32, None), ((3, 60, 35, 30), 32, None), ((50, 70, 90, 30), 32, None),
    ((8, 40, 40, 8), None, None), ((10000, 10010, 10010, 10000), None, None),
    ((8, 40, 40, 8), 32, 4326)])
def test_slice_raster_window_equals_jax(bbox, chip_size, crs_in):
    data = np.arange(3 * 64 * 64, dtype=np.uint16).reshape(3, 64, 64)
    tr, jtr = (A.from_origin(500000, 4763000, 30, 30) for A in (Affine, JaxAffine))
    c0, r0, c1, r1 = bbox
    x0, y0 = tr * (c0, r0)
    x1, y1 = tr * (c1, r1)
    b = (x0, y0, x1, y1)
    if crs_in == 4326:
        t = crs.Transformer.from_crs(32633, 4326)
        (lo_x, hi_x), (lo_y, hi_y) = t.transform(np.asarray([x0, x1]), np.asarray([y0, y1]))
        b = (float(lo_x), float(lo_y), float(hi_x), float(hi_y))
    kw = dict(bbox_crs=crs_in, raster_crs=32633 if crs_in else None, chip_size=chip_size)
    got = geo_utils.slice_raster_window(data, tr, b, **kw)
    want = jax_geo.slice_raster_window(data, jtr, b, **kw)
    assert (got is None) == (want is None)
    if got is not None:
        assert np.array_equal(got[0], want[0])
        assert got[1].to_gdal() == want[1].to_gdal()


@pytest.mark.parametrize("bboxes,chip_size,res,crs_in", [
    ([[15.0, 43.0, 15.2, 43.2]], 32, 0.00269494585235856, 4326),
    ([[15.0, 43.0, 15.05, 43.02], [11.9, 43.0, 12.1, 43.1]], 16, 0.0015, 4326),
    ([[179.5, 10.0, 180.0, 10.3]], 32, 0.01, 4326),
    ([[500000.0, 4760000.0, 506000.0, 4766000.0]], 32, 30.0, 32633)])
def test_create_grid_polygons_equals_jax(bboxes, chip_size, res, crs_in):
    got = geo_utils.create_grid_polygons(bboxes, "2022-05-25", chip_size, res, crs_in)
    want = jax_geo.create_grid_polygons(bboxes, "2022-05-25", chip_size, res, crs_in)
    assert got == want.to_dict("records")
    assert len(got) > 0
    assert np.array_equal(geo_utils.get_complete_chips_coords(0.0, 1.0, 0.01, 32, 180),
                          jax_geo.get_complete_chips_coords(0.0, 1.0, 0.01, 32, 180))


def test_points_in_bbox_equals_jax():
    df = pd.DataFrame({"x": LONS, "y": LATS, "k": np.arange(len(LATS))})
    rows = df.to_dict("records")
    for bbox in ((-10, -10, 10, 10), (0, 0, 180, 90), (15, 43, 15, 43)):
        assert (geo_utils.points_in_bbox(rows, bbox)
                == jax_geo.points_in_bbox(df, bbox).to_dict("records"))


# ---------------------------------------------------------------------------
# STAC selection and tile grouping
# ---------------------------------------------------------------------------


def _item_dicts(n=12, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ts = datetime(2022, 5, 1, tzinfo=timezone.utc).timestamp() + rng.uniform(0, 40) * 86400
        lon, lat = rng.uniform(14.5, 15.5), rng.uniform(42.5, 43.5)
        out.append({"id": f"HLS.S30.T33TUN.{i:03d}", "collection": "sentinel-2-l2a"
                    if i % 3 == 0 else "HLSS30_2.0",
                    "bbox": [lon - 0.4, lat - 0.4, lon + 0.4, lat + 0.4],
                    "properties": {"datetime": datetime.fromtimestamp(
                        round(ts), timezone.utc).isoformat(), "eo:cloud_cover": int(i % 4)},
                    "assets": {"red": {"href": f"r{i}"}, "B02": {"href": f"b{i}"}}})
    return out


def _both_items(dicts):
    return ([jax_stac.StacItem.from_dict(copy.deepcopy(d)) for d in dicts],
            [stac.StacItem.from_dict(copy.deepcopy(d)) for d in dicts])


def test_daytime_and_rename_equal_jax():
    hours = [datetime(2022, m, d, h, tzinfo=timezone.utc).isoformat()
             for m in (1, 6, 12) for d in (1, 21) for h in range(0, 24, 3)]
    dicts = [{"id": f"i{k}", "collection": "c", "bbox": list(b),
              "properties": {"datetime": h}, "assets": {}}
             for k, (h, b) in enumerate((h, b) for h in hours for b in (
                 (-0.1, -0.1, 0.1, 0.1), (179.8, -0.1, 180.0, 0.1), (14.9, 79.9, 15.1, 80.1),
                 (14.9, 42.9, 15.1, 43.1), (-120.1, 35.0, -119.9, 35.2)))]
    jitems, pitems = _both_items(dicts)
    assert [stac.is_daytime(i) for i in pitems] == [jax_stac.is_daytime(i) for i in jitems]
    assert not stac.is_daytime(stac.StacItem("x", "c", (0, 0, 1, 1), None))
    jitems, pitems = _both_items(_item_dicts())
    nameplate = {"sentinel-2-l2a": {"red": "B04"}, "HLSS30_2.0": {"B02": "BLUE"}}
    assert ([i.to_dict() for i in stac.rename_stac_items(pitems, nameplate)]
            == [i.to_dict() for i in jax_stac.rename_stac_items(jitems, nameplate)])


def _observations(n=40, seed=4):
    rng = np.random.default_rng(seed)
    days = rng.integers(0, 30, n)
    return pd.DataFrame({
        "x": rng.uniform(14.0, 16.0, n), "y": rng.uniform(42.0, 44.0, n),
        "label": rng.integers(0, 2, n),
        "date": [pd.Timestamp("2022-05-10") + pd.Timedelta(days=int(d)) for d in days]})


@pytest.mark.parametrize("num_steps,step,tol,tol_min,time_col", [
    (1, 10, 5, 0, False), (3, 5, 3, 0, False), (3, 7, 2, 90, True)])
def test_tile_info_selection_and_records_equal_jax(num_steps, step, tol, tol_min, time_col):
    """get_tiles -> get_tile_info -> dispatch -> closest items ->
    create_records_with_items on both sides."""
    jdf = _observations()
    if time_col:
        jdf["time"] = "10:30:00"
    jdf["input_features_date"] = jdf["date"]
    rows = [{**r, "date": r["date"].to_pydatetime(),
             "input_features_date": r["input_features_date"].to_pydatetime()}
            for r in jdf.to_dict("records")]
    jtiles = jax_pipeline.get_tiles(jdf, min_count=3)
    ptiles = pipeline.get_tiles(rows, min_count=3)
    assert [r["mgrs_tile_id"] for r in ptiles] == list(jtiles["mgrs_tile_id"])
    assert [r["counts"] for r in ptiles] == list(jtiles["counts"])
    jinfo, jq = jax_pipeline.get_tile_info(jtiles, num_steps, step, tol, tol_min)
    pinfo, pq = pipeline.get_tile_info(ptiles, num_steps, step, tol, tol_min)
    assert pq == jq
    for p, j in zip(pinfo, jinfo.to_dict("records")):
        assert {k: p[k] for k in j} == j

    jitems, pitems = _both_items(_item_dicts(20))
    jdb = {t: jitems for t in jinfo["tile_id"]}
    pdb = {t: pitems for t in (r["tile_id"] for r in pinfo)}
    jdata = jtiles.copy()
    jdata["tile_queries"] = jq
    pdata = [{**r, "tile_queries": q} for r, q in zip(ptiles, pq)]
    kw = dict(item_id_field="i", candidate_items_field="c", items_field="its",
              temporal_tolerance=tol, temporal_tolerance_minutes=tol_min)
    jbest = jax_stac.find_best_items(jdata, jdb, **kw)
    pbest = stac.find_best_items(pdata, pdb, **kw)
    assert list(pbest) == list(jbest)
    for t in jbest:
        assert ([[i and i.id for i in r["its"]] for r in pbest[t]]
                == [[i and i.id for i in its] for its in jbest[t]["its"]])
    jrec, jds = jax_stac.create_records_with_items(jbest, "g", "its")
    prec, pds = stac.create_records_with_items(pbest, "g", "its")
    assert pds == jds and len(prec) == len(jrec)
    assert ([r["stac_items_str"] for r in prec] == list(jrec["stac_items_str"])
            if len(jrec) else prec == [])


def test_raster_tile_info_equals_jax():
    grid = jax_geo.create_grid_polygons([[15.0, 43.0, 15.2, 43.1], [11.9, 43.0, 12.1, 43.1]],
                                        "2022-05-25", 16, 0.002, 4326)
    grid["input_features_date"] = pd.to_datetime(grid["date"])
    rows = geo_utils.create_grid_polygons([[15.0, 43.0, 15.2, 43.1], [11.9, 43.0, 12.1, 43.1]],
                                          "2022-05-25", 16, 0.002, 4326)
    rows = [{**r, "input_features_date": table.to_datetime(r["date"])} for r in rows]
    jinfo, jq = jax_pipeline.get_raster_tile_info(grid, 3, 10, 5, 30)
    pinfo, pq = pipeline.get_raster_tile_info(rows, 3, 10, 5, 30)
    assert pq == jq and pinfo == jinfo.to_dict("records")


def test_find_closest_items_and_dispatch_edges_equal_jax():
    jitems, pitems = _both_items(_item_dicts(6))
    obs = {"tile_queries": ("T", ["2022-05-12T00:00:00", "2022-04-01T00:00:00"])}
    for tol in (0, 2, 30):
        assert ([i and i.id for i in stac.find_closest_items({**obs, "c": pitems}, "c", tol)]
                == [i and i.id for i in jax_stac.find_closest_items(
                    pd.Series({**obs, "c": jitems}), "c", tol)])
    assert stac.find_closest_items(obs, "c", 5) == [None, None]
    assert stac.dispatch_candidate_items([{"x": 100.0, "y": 0.0}], pitems, "c") is None
    assert jax_stac.dispatch_candidate_items(
        pd.DataFrame({"x": [100.0], "y": [0.0]}), jitems, "c") is None


# ---------------------------------------------------------------------------
# table helpers against pandas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frame,columns,index", [
    ([], [], False),
    ([{"Input": "chips/a.tif", "Label": "seg_maps/a.tif"}], ["Input", "Label"], False),
    ([], ["Input", "Label"], True),
    ([{"Input": "/x/chips/a,b.tif"}, {"Input": 'q"uote'}], ["Input"], True),
    ([{"a": 1, "b": 0.1, "c": None, "d": "x y"}, {"a": 2, "b": 1e-20, "c": "z", "d": ""}],
     ["a", "b", "c", "d"], False)])
def test_write_csv_is_pandas_to_csv(tmp_path, frame, columns, index):
    table.write_csv(str(tmp_path / "port.csv"), frame, columns, index=index)
    pd.DataFrame(frame, columns=columns or None).to_csv(tmp_path / "pandas.csv", index=index)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


def test_read_csv_types_are_pandas(tmp_path):
    path = tmp_path / "obs.csv"
    df = _observations(25)
    df["s"] = ["a", "", "c", "d", "e"] * 5
    df["n"] = [1.5, None, 2.0, 3.0, 4.0] * 5
    df["date"] = df["date"].dt.strftime("%Y-%m-%d")
    df.to_csv(path, index=False)
    rows, columns = table.read_csv(str(path))
    want = pd.read_csv(path)
    assert columns == list(want.columns)
    for r, w in zip(rows, want.to_dict("records")):
        for k in columns:
            if isinstance(w[k], float) and np.isnan(w[k]):
                assert r[k] is None or np.isnan(r[k])
            else:
                assert r[k] == w[k] and type(r[k]) is type(w[k].item() if hasattr(w[k], "item")
                                                         else w[k]), k
    (tmp_path / "empty.csv").write_text("\n")
    assert table.read_csv(str(tmp_path / "empty.csv")) == ([], [])


def test_group_dedup_explode_are_pandas():
    df = pd.DataFrame({"k": ["b", "a", "c", "a", "b", "b"], "v": range(6),
                       "lst": [["x"], ["y", "z"], ["w"], ["u", "v", "t"], ["s"], ["r", "q"]]})
    rows = df.to_dict("records")
    groups = table.group_by(rows, "k")
    assert list(groups) == [k for k, _ in df.groupby("k")]
    assert all(groups[k] == g.to_dict("records") for k, g in df.groupby("k"))
    for keep in ("first", "last"):
        assert (table.drop_duplicates(rows, "k", keep)
                == df.drop_duplicates(subset=["k"], keep=keep).to_dict("records"))
    assert table.explode(rows, "lst") == df.explode("lst", ignore_index=True).to_dict("records")


@pytest.mark.parametrize("date,time_", [("2023-06-16", None), ("2023-06-01", "10:30:00"),
                                        ("2023-06-01T23:59:59", None),
                                        ("2023-03-01 00:00:00", "1 days 02:00:00"),
                                        ("2024-02-29", "00:00:01.5")])
def test_dates_are_pandas(date, time_):
    from instageo_tpu_torch.data.chip_creator import month_begin_before

    got = table.to_datetime(date)
    want = pd.to_datetime(pd.Series([date]))[0]
    if time_:
        got, want = got + table.to_timedelta(time_), want + pd.to_timedelta(time_)
    assert got == want.to_pydatetime()
    assert month_begin_before(got) == (want - pd.offsets.MonthBegin(1)).to_pydatetime()


@pytest.mark.parametrize("bad", ["16/06/2023", "June 16", ""])
def test_dates_refuse_other_forms(bad):
    with pytest.raises(ValueError, match="ISO 8601"):
        table.to_datetime(bad)


# ---------------------------------------------------------------------------
# flags against absl
# ---------------------------------------------------------------------------

FLAG_CASES = [
    ["--chip_size=32", "--min_count", "7", "--data_source", "S2"],
    ["--daytime_only", "--noshift_to_month_start", "--nois_time_series_task"],
    ["--shift_to_month_start=false", "--daytime_only=true", "--qa_check=false"],
    ["--is_bbox_feature=true", "--date=2024-06-01", "--bbox_feature_path", "/b.json"],
    ["--mask_types=cloud,water", "--filters=label:>=:1,mgrs:==:33TUN"],
    ["--mask_types=", "--window_size=2", "--src_crs=32633", "--cloud_coverage=0"],
    ["--spatial_resolution=30", "--temporal_tolerance_minutes=15", "--task_type=reg",
     "--masking_strategy", "any", "--processing_method=download-only"],
    ["-chip_size=64", "-noqa_check", "--data_format=parquet"],
]


# absl's registry is one per process: where the JAX data cleaner was
# imported first, ``window_size`` is its flag (default 1, no lower bound),
# and the JAX chip creators read it through ``chip_window_size``.


@pytest.mark.parametrize("argv", FLAG_CASES)
def test_flags_parse_as_absl(argv):
    got = flags.parse_flags(argv, flags.COMMON_FLAGS + flags.RASTER_FLAGS)
    jf = jax_rcc.FLAGS
    jf.unparse_flags()
    try:
        jf(["prog"] + argv)
        for f in flags.COMMON_FLAGS + flags.RASTER_FLAGS:
            if f.name not in ("device", "window_size"):
                assert getattr(got, f.name) == getattr(jf, f.name), f.name
        assert flags.chip_window_size(got) == jax_flags.chip_window_size()
        assert got.device == "cuda"
    finally:
        jf.unparse_flags()


@pytest.mark.parametrize("argv", [["--mask_types=snow"], ["--cloud_coverage=101"],
                                  ["--window_size=-1"], ["--data_source=L8"],
                                  ["--chip_size=big"], ["--daytime_only=maybe"],
                                  ["--no_such_flag=1"]])
def test_flags_refuse_what_absl_refuses(argv):
    with pytest.raises(SystemExit):
        flags.parse_flags(argv)
    if argv == ["--window_size=-1"] and jax_rcc.FLAGS["window_size"].default != 0:
        return  # the data cleaner's flag takes it; the chip creators' refuses it
    jf = jax_rcc.FLAGS
    jf.unparse_flags()
    try:
        with pytest.raises(Exception):
            jf(["prog"] + argv)
    finally:
        jf.unparse_flags()


# ---------------------------------------------------------------------------
# urllib clients on a local server
# ---------------------------------------------------------------------------


class _Stac(http.server.BaseHTTPRequestHandler):
    """POST /search: two pages of features, the second behind links[rel=next]
    with a body; GET serves files from ``files``."""

    pages = {}
    files = {}
    bodies = []

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).bodies.append(body)
        page = self.pages[body.get("page", 0)]
        self._send(200, json.dumps(page).encode(), "application/json")

    def do_GET(self):
        data = self.files.get(self.path.lstrip("/"))
        self._send(200 if data is not None else 404, data or b"missing",
                   "application/octet-stream")

    def _send(self, code, data, ctype):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture
def server():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Stac)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def test_stac_search_paginates_as_jax(server):
    feats = _item_dicts(5)
    _Stac.pages = {0: {"features": feats[:3], "links": [
        {"rel": "next", "href": f"{server}/search", "body": {"page": 1}}]},
        1: {"features": feats[3:], "links": []}}
    _Stac.bodies = []
    kw = dict(collections=["HLSS30_2.0"], datetime="2022-05-01/2022-06-01",
              bbox=(14.0, 42.0, 16.0, 44.0), query={"eo:cloud_cover": {"lte": 10}},
              sortby=[{"field": "datetime", "direction": "asc"}])
    got = stac.StacClient.open(server).search(**kw)
    port_bodies, _Stac.bodies = _Stac.bodies, []
    want = jax_stac.StacClient.open(server).search(**kw)
    assert [i.to_dict() for i in got] == [i.to_dict() for i in want]
    assert port_bodies == _Stac.bodies and len(got) == 5
    _Stac.pages = {0: {"features": []}}
    assert stac.StacClient.open(server).search(collections=["x"]) == []


def test_stac_search_error_status(server, monkeypatch):
    monkeypatch.setattr(_Stac, "do_POST", lambda self: self._send(503, b"busy", "text/plain"))
    with pytest.raises(stac.StacAPIError, match="503: busy"):
        stac.StacClient.open(server).search(collections=["x"])


def test_downloads_over_urllib(server, tmp_path, monkeypatch):
    monkeypatch.setattr(downloads, "MIN_VALID_SIZE", 64)
    _Stac.files = {"a.tif": os.urandom(5000), "b.tif": os.urandom(100), "tiny.tif": b"x"}
    urls = {n: f"{server}/{n}" for n in ("a.tif", "b.tif", "tiny.tif", "gone.tif")}
    no_retry = functools.partial(downloads.download_file.__wrapped__)
    monkeypatch.setattr(downloads, "download_file", no_retry)
    done = downloads.parallel_download(urls, str(tmp_path / "g"), headers={}, threads=3)
    assert sorted(os.path.basename(p) for p in done) == ["a.tif", "b.tif"]
    for name in ("a.tif", "b.tif"):
        assert (tmp_path / "g" / name).read_bytes() == _Stac.files[name]
    assert not any(p.name.endswith(".part") for p in (tmp_path / "g").iterdir())


def test_read_csv_floats_are_pandas_bit_for_bit(tmp_path):
    """pandas' default float parser is not correctly rounded; the port reads
    the observations' coordinates as it does, bit for bit."""
    rng = np.random.default_rng(11)
    vals = np.concatenate([rng.uniform(-180, 180, 4000), rng.normal(0, 1e-5, 500),
                           10.0 ** rng.uniform(-30, 30, 500)])
    strs = [repr(float(v)) for v in vals] + [
        "15.0", "0.5", "1e-5", "-3.25e2", "007.5", "1.", ".5", "1E3",
        "123456789012345678901234.5", "0.000000000000000000001234567890123456789"]
    path = tmp_path / "v.csv"
    path.write_text("v\n" + "\n".join(strs) + "\n")
    got = np.asarray([r["v"] for r in table.read_csv(str(path))[0]])
    want = pd.read_csv(path)["v"].to_numpy()
    assert np.array_equal(got, want)
    assert not np.array_equal(np.asarray([float(s) for s in strs]), want)
