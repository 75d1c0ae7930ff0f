"""The port's Parquet reader and writer (``instageo_tpu_torch/data/parquet.py``)
against pyarrow and pandas.

Reader: files that pyarrow writes across codecs (none, snappy, gzip),
dictionary on and off, data pages v1 and v2, and small or whole row
groups, read back equal to ``pq.read_table(...).to_pylist()`` with the
module's normalisation (a ``pd.Timestamp`` as its ``datetime``, a null in a
float column as NaN, the saved pandas index left out). Filters: every op
against pyarrow's, nulls included. Snappy: the decompressor against
``pa.compress``. Refusals name the feature. Writer: ``pd.read_parquet`` of
the port's file equals the DataFrame the JAX CLIs save (``assert_frame_equal``,
dtypes checked). Tolerance: equal, value for value.
"""

import datetime as dt
import decimal
import json
import math
import os
from zoneinfo import ZoneInfo

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from instageo_tpu_torch.data import parquet

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE = os.path.join(REPO, "tests", "torch_fixtures", "observations.parquet")


def _normalise(rows, table):
    """pyarrow's rows as ``parquet.read_table`` gives them."""
    floats = {f.name for f in table.schema if pa.types.is_floating(f.type)}
    out = []
    for r in rows:
        row = {}
        for k, v in r.items():
            if v is None and k in floats:
                v = math.nan
            elif isinstance(v, pd.Timestamp):
                v = v.to_pydatetime()
            row[k] = v
        out.append(row)
    return out


def _same(a, b):
    """Row lists equal, NaN equal to NaN."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert list(ra) == list(rb)
        for k in ra:
            x, y = ra[k], rb[k]
            if isinstance(x, float) and math.isnan(x):
                assert isinstance(y, float) and math.isnan(y), (k, x, y)
            else:
                assert x == y and type(x) is type(y), (k, x, y)


def _table(n=37, seed=0):
    rng = np.random.default_rng(seed)
    ints = rng.integers(-2**40, 2**40, n)
    floats = rng.standard_normal(n)
    base = dt.datetime(2022, 5, 25, 10, 30)
    lists = []
    for i in range(n):
        if i % 7 == 3:
            lists.append(None)
        elif i % 7 == 5:
            lists.append([])
        else:
            lists.append([float(v) if j != 1 or i % 5 else None
                          for j, v in enumerate(rng.standard_normal(i % 4 + 1))])
    return pa.table({
        "i64": pa.array(ints.tolist(), pa.int64()),
        "i32": pa.array((ints % 1000).tolist(), pa.int32()),
        "i8": pa.array((ints % 100).tolist(), pa.int8()),
        "u16": pa.array((np.abs(ints) % 60000).tolist(), pa.uint16()),
        "u32": pa.array((np.abs(ints) % 4_000_000_000).tolist(), pa.uint32()),
        "u64": pa.array((np.abs(ints) * 1000).tolist(), pa.uint64()),
        "f64": pa.array([None if i % 6 == 2 else float(v) for i, v in enumerate(floats)]),
        "f32": pa.array([None if i % 9 == 4 else float(v) for i, v in enumerate(floats)],
                        pa.float32()),
        "s": pa.array([None if i % 5 == 1 else f"obs-{i % 4}-é" for i in range(n)]),
        "ts_us": pa.array([None if i % 8 == 7 else base + dt.timedelta(hours=i, microseconds=i)
                           for i in range(n)], pa.timestamp("us")),
        "ts_ns": pa.array([base + dt.timedelta(minutes=i) for i in range(n)],
                          pa.timestamp("ns")),
        "ts_ms_utc": pa.array([base + dt.timedelta(seconds=i) for i in range(n)],
                              pa.timestamp("ms", tz="UTC")),
        "day": pa.array([dt.date(2020, 1, 1) + dt.timedelta(days=i) for i in range(n)]),
        "flag": pa.array([None if i % 10 == 9 else bool(i % 3) for i in range(n)]),
        "bbox": pa.array(lists, pa.list_(pa.float64())),
        "blob": pa.array([bytes([i % 256]) * (i % 3) for i in range(n)]),
        "nothing": pa.nulls(n),
    })


MATRIX = [(codec, dictionary, version, rows)
          for codec in ("none", "snappy", "gzip")
          for dictionary in (True, False)
          for version in ("1.0", "2.0")
          for rows in (8, None)]


@pytest.mark.parametrize("codec,dictionary,version,rows", MATRIX,
                         ids=[f"{c}-{'dict' if d else 'plain'}-v{v[0]}-{r or 'whole'}"
                              for c, d, v, r in MATRIX])
def test_reader_equals_pyarrow(tmp_path, codec, dictionary, version, rows):
    table = _table()
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path, compression=codec, use_dictionary=dictionary,
                   data_page_version=version, row_group_size=rows, data_page_size=64,
                   write_batch_size=4)
    meta = pq.ParquetFile(path).metadata
    assert meta.num_row_groups == (1 if rows is None else -(-table.num_rows // rows))
    want = _normalise(pq.read_table(path).to_pylist(), table)
    _same(parquet.read_table(path), want)
    cols = ["bbox", "s", "i64"]
    _same(parquet.read_table(path, columns=cols), [{c: r[c] for c in cols} for r in want])


def test_reader_dictionary_falls_back_to_plain(tmp_path):
    """A chunk whose dictionary outgrows its limit goes on in PLAIN pages."""
    n = 3000
    table = pa.table({"s": [f"value-{i}" for i in range(n)],
                      "x": np.arange(n, dtype=np.float64) / 7})
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path, dictionary_pagesize_limit=512, data_page_size=1024,
                   compression="snappy")
    col = pq.ParquetFile(path).metadata.row_group(0).column(0)
    assert col.has_dictionary_page and "PLAIN" in col.encodings
    _same(parquet.read_table(path), _normalise(pq.read_table(path).to_pylist(), table))


def test_reader_int96_and_item_named_lists(tmp_path):
    """INT96 timestamps and a 3-level list whose element is named ``item``
    (pyarrow's non-compliant nested names)."""
    table = pa.table({"t": pa.array([dt.datetime(2021, 3, 4, 5, 6, 7, 8), None],
                                    pa.timestamp("us")),
                      "l": pa.array([[1, 2], None], pa.list_(pa.int32()))})
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path, use_deprecated_int96_timestamps=True,
                   use_compliant_nested_type=False)
    assert "int96" in str(pq.ParquetFile(path).schema)
    # pyarrow reads INT96 back as timestamp[ns]: the same instants.
    _same(parquet.read_table(path), _normalise(pq.read_table(path).to_pylist(), table))
    pq.write_table(pa.table({"l": pa.array([[1.5], [], None], pa.list_(pa.float64()))}), path)
    assert parquet.read_table(path) == [{"l": [1.5]}, {"l": []}, {"l": None}]


def test_reader_legacy_two_level_list_of_primitives(tmp_path):
    """``optional group l (LIST) { repeated double array; }``, as older
    writers made it, written with the module's own Thrift encoder."""
    from instageo_tpu_torch.data.parquet import (
        DATA_PAGE, DOUBLE, LIST, OPTIONAL, REPEATED, REQUIRED, RLE, T_BINARY, T_I32, T_I64,
        T_LIST, T_STRUCT, _length_prefixed, _put_struct, _rle_encode)

    rows = [[1.0, 2.0], [], None, [3.0]]
    reps = np.asarray([0, 1, 0, 0, 0])
    defs = np.asarray([2, 2, 1, 0, 2])
    raw = (_length_prefixed(_rle_encode(reps, 1)) + _length_prefixed(_rle_encode(defs, 2))
           + np.asarray([1.0, 2.0, 3.0], "<f8").tobytes())
    header = bytearray()
    _put_struct(header, [(1, T_I32, DATA_PAGE), (2, T_I32, len(raw)), (3, T_I32, len(raw)),
                         (5, T_STRUCT, [(1, T_I32, 5), (2, T_I32, 0), (3, T_I32, RLE),
                                        (4, T_I32, RLE)])])
    body = b"PAR1" + bytes(header) + raw
    footer = bytearray()
    size = len(header) + len(raw)
    _put_struct(footer, [
        (1, T_I32, 1),
        (2, T_LIST, (T_STRUCT, [
            [(3, T_I32, REQUIRED), (4, T_BINARY, "schema"), (5, T_I32, 1)],
            [(3, T_I32, OPTIONAL), (4, T_BINARY, "l"), (5, T_I32, 1), (6, T_I32, LIST)],
            [(1, T_I32, DOUBLE), (3, T_I32, REPEATED), (4, T_BINARY, "array")]])),
        (3, T_I64, 4),
        (4, T_LIST, (T_STRUCT, [[(1, T_LIST, (T_STRUCT, [[(2, T_I64, 4), (3, T_STRUCT, [
            (1, T_I32, DOUBLE), (2, T_LIST, (T_I32, [0, RLE])),
            (3, T_LIST, (T_BINARY, ["l", "array"])), (4, T_I32, 0), (5, T_I64, 5),
            (6, T_I64, size), (7, T_I64, size), (9, T_I64, 4)])]])),
            (2, T_I64, size), (3, T_I64, 4)]])),
    ])
    path = tmp_path / "legacy.parquet"
    path.write_bytes(body + bytes(footer) + len(footer).to_bytes(4, "little") + b"PAR1")
    assert pq.read_table(str(path)).to_pylist() == [{"l": r} for r in rows]
    assert parquet.read_table(str(path)) == [{"l": r} for r in rows]


FILTERS = [("=", 3), ("==", 3), ("!=", 3), ("<", 3), (">", 3), ("<=", 3), (">=", 3),
           ("in", [1, 3]), ("not in", [1, 3]), ("==", "b"), ("!=", "b"), ("in", ["a", "b"]),
           ("not in", ["a"]), (">", 0.5), ("<=", dt.datetime(2022, 1, 3))]


@pytest.mark.parametrize("op,value", FILTERS, ids=[f"{o}-{v}" for o, v in FILTERS])
def test_filters_equal_pyarrow(tmp_path, op, value):
    """Each op keeps the rows pyarrow keeps; a null passes ``not in`` only."""
    table = pa.table({
        "n": pa.array([1, None, 3, 2, 3, 5, None]),
        "s": pa.array(["a", "b", None, "b", "c", "a", None]),
        "f": pa.array([0.25, None, 0.75, 1.5, float("nan"), 0.5, 2.0]),
        "t": pa.array([dt.datetime(2022, 1, d) for d in (1, 2, 3, 4, 5, 6, 7)]),
    })
    path = str(tmp_path / "f.parquet")
    pq.write_table(table, path)
    col = {str: "s", float: "f", dt.datetime: "t"}.get(
        type(value[0] if isinstance(value, list) else value), "n")
    flt = [(col, op, value)]
    want = _normalise(pq.read_table(path, filters=flt).to_pylist(), table)
    _same(parquet.read_table(path, filters=flt), want)
    both = [("n", ">=", 2), (col, op, value)]  # ANDed
    want = _normalise(pq.read_table(path, filters=both).to_pylist(), table)
    _same(parquet.read_table(path, filters=both), want)


@given(st.binary(max_size=3000), st.integers(0, 4))
@settings(max_examples=25, derandomize=True, deadline=None)
def test_snappy_equals_pyarrow(data, repeat):
    raw = data * (repeat + 1) + bytes(repeat * 40)  # runs: long overlapping copies
    packed = pa.compress(raw, codec="snappy", asbytes=True)
    assert parquet.snappy_decompress(packed) == raw


def test_snappy_random_blocks_equal_pyarrow():
    rng = np.random.default_rng(7)
    for size in (0, 1, 59, 60, 61, 255, 256, 65536 + 17, 300_000):
        raw = rng.integers(0, 4, size, dtype=np.uint8).tobytes()
        packed = pa.compress(raw, codec="snappy", asbytes=True)
        assert parquet.snappy_decompress(packed) == raw


@pytest.mark.parametrize("what,kwargs,name", [
    ("zstd", dict(compression="zstd"), "ZSTD"),
    ("lz4", dict(compression="lz4"), "LZ4"),
    ("brotli", dict(compression="brotli"), "BROTLI"),
    ("delta", dict(use_dictionary=False, column_encoding={"n": "DELTA_BINARY_PACKED"}),
     "DELTA_BINARY_PACKED"),
    ("split", dict(use_dictionary=False, column_encoding={"n": "BYTE_STREAM_SPLIT"}),
     "BYTE_STREAM_SPLIT"),
])
def test_unsupported_features_are_refused_by_name(tmp_path, what, kwargs, name):
    path = str(tmp_path / f"{what}.parquet")
    pq.write_table(pa.table({"n": pa.array(np.arange(50, dtype=np.int64))}), path, **kwargs)
    with pytest.raises(parquet.ParquetError, match=name):
        parquet.read_table(path)


@pytest.mark.parametrize("column,name", [
    (pa.array([{"a": 1}]), "struct"),
    (pa.array([[("k", 1)]], pa.map_(pa.string(), pa.int64())), "MAP"),
    (pa.array([[[1.0]]], pa.list_(pa.list_(pa.float64()))), "LIST of lists"),
    (pa.array([decimal.Decimal("1.50")], pa.decimal128(5, 2)), "DECIMAL"),
    (pa.array([dt.time(1, 2)]), "TIME"),
    (pa.array([dt.datetime(2020, 1, 1)], pa.timestamp("ns")).cast(pa.int64()).cast(
        pa.timestamp("ns")), None),
])
def test_unsupported_types_are_refused_by_name(tmp_path, column, name):
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"c": column}), path)
    if name is None:  # whole microseconds: read
        assert parquet.read_table(path) == [{"c": dt.datetime(2020, 1, 1)}]
        pq.write_table(pa.table({"c": pa.array([1], pa.timestamp("ns"))}), path)
        name = "nanoseconds"
    with pytest.raises(parquet.ParquetError, match=name):
        parquet.read_table(path)


def test_pandas_index_columns_are_left_out(tmp_path):
    path = str(tmp_path / "t.parquet")
    pd.DataFrame({"a": [1, 2, 3]}, index=[5, 7, 9]).to_parquet(path)
    assert "__index_level_0__" in pq.read_table(path).column_names
    assert parquet.read_table(path) == [{"a": 1}, {"a": 2}, {"a": 3}]


def test_fixture_reads_equal_to_its_json():
    """The committed pandas-written fixture (snappy, dictionaries, a time
    column, a null and a ``list<double>``) against its expected records and
    against pyarrow."""
    with open(FIXTURE[:-len(".parquet")] + ".json") as f:
        expected = json.load(f)
    rows = parquet.read_table(FIXTURE)
    assert json.loads(json.dumps(rows, default=str)) == expected
    table = pq.read_table(FIXTURE)
    _same(rows, _normalise(table.to_pylist(), table))
    meta = pq.ParquetFile(FIXTURE).metadata.row_group(0)
    assert {meta.column(i).compression for i in range(meta.num_columns)} == {"SNAPPY"}
    assert any(meta.column(i).has_dictionary_page for i in range(meta.num_columns))


# --- the writer ----------------------------------------------------------------

POINT_ROWS = [
    {"x": 14.990245265717922, "y": 43.00715862689299, "label": 1,
     "date": dt.datetime(2022, 6, 1, 10, 30), "time": "10:30:00",
     "input_features_date": dt.datetime(2022, 5, 27, 10, 30), "mgrs_tile_id": "33TVH",
     "counts": 2, "stac_items_str": "HLS.S30.T33TUN.2022145T100000.v2.0"},
    {"x": 15.0, "y": -43.5, "label": 0, "date": dt.datetime(2022, 6, 1, 10, 30, 0, 5),
     "time": "10:30:00", "input_features_date": dt.datetime(2022, 5, 27),
     "mgrs_tile_id": "33TVH", "counts": 2, "stac_items_str": "é_ü"},
]
RASTER_ROWS = [
    {"label_filename": "mask_0.tif", "date": dt.datetime(2022, 5, 25),
     "bbox": (499160.0, 4760634.79608729, 500120.0, 4761594.79608729),
     "bbox_4326": [14.98969313, 42.99837862, 15.00147241, 43.00702396],
     "mgrs_tile_id": "33TVH", "input_features_date": dt.datetime(2022, 5, 25),
     "x": 14.995582771522376, "y": 43.002701288217324, "stac_items_str": "a_b"},
    {"label_filename": "mask_1.tif", "date": dt.datetime(2022, 5, 25),
     "bbox": (1.0, 2.0, 3.0, 4.0), "bbox_4326": [1.0, 2, 3.0, 4.0],
     "mgrs_tile_id": "33TVJ", "input_features_date": dt.datetime(2022, 5, 25),
     "x": 2.0, "y": 3.0, "stac_items_str": "c"},
]
MIXED_ROWS = [{"a": 1, "b": 1.5, "c": True, "d": "x", "e": None},
              {"a": 2, "b": None, "c": False, "d": None, "e": 2},
              {"a": 3, "b": 2, "c": True, "d": "z", "e": float("nan")}]
# A CSV column with every cell blank (NaN, as pandas reads it) and a
# column of None only.
NULL_ROWS = [{"x": 1.5, "blank": math.nan, "none": None},
             {"x": 2.5, "blank": math.nan, "none": None}]
# Dates with an offset or ``Z`` (``table.to_datetime``), and a zone key.
_PLUS2 = dt.timezone(dt.timedelta(hours=2))
ZONE_ROWS = [
    {"date": dt.datetime(2022, 6, 1, 10, 30, tzinfo=dt.timezone.utc),
     "local": dt.datetime(2022, 6, 1, 12, 30, 0, 5, tzinfo=_PLUS2),
     "west": dt.datetime(1969, 12, 31, 23, tzinfo=dt.timezone(-dt.timedelta(hours=5,
                                                                           minutes=30))),
     "named": dt.datetime(2022, 6, 1, 12, 30, tzinfo=ZoneInfo("Europe/Rome"))},
    {"date": dt.datetime(2022, 6, 2, tzinfo=dt.timezone.utc), "local": None,
     "west": dt.datetime(2000, 1, 1, tzinfo=dt.timezone(-dt.timedelta(hours=5, minutes=30))),
     "named": dt.datetime(2022, 12, 1, tzinfo=ZoneInfo("Europe/Rome"))},
]


@pytest.mark.parametrize("rows", [POINT_ROWS, RASTER_ROWS, MIXED_ROWS, NULL_ROWS, ZONE_ROWS,
                                  []],
                         ids=["points", "raster", "mixed", "nulls", "zones", "empty"])
def test_writer_reads_back_as_the_jax_cli_frame(tmp_path, rows):
    """``pd.read_parquet`` of the port's file equals that of pandas' own
    ``to_parquet`` of the same records, dtypes and index included; the
    port's reader gives the records back."""
    mine, theirs = str(tmp_path / "port.parquet"), str(tmp_path / "pandas.parquet")
    parquet.write_records(mine, rows)
    pd.DataFrame(rows).to_parquet(theirs)  # what the JAX CLIs save
    pd.testing.assert_frame_equal(pd.read_parquet(mine), pd.read_parquet(theirs),
                                  check_dtype=True, check_index_type=True,
                                  check_column_type=True, check_exact=True)
    assert not os.path.exists(mine + ".tmp")
    back = parquet.read_table(mine)
    _same(back, parquet.read_table(theirs))
    for r, b in zip(rows, back):
        assert set(b) == set(r)
        for k, v in r.items():
            if isinstance(v, tuple):
                v = list(v)
            if v is None or (isinstance(v, float) and math.isnan(v)):
                assert b[k] is None or math.isnan(b[k])
            elif isinstance(v, dt.datetime):  # the same instant in the same zone
                assert (b[k], b[k].utcoffset()) == (v, v.utcoffset())
            else:
                assert b[k] == v
    # The Arrow schema pyarrow keeps (the time zones live there).
    assert pq.read_schema(mine).remove_metadata() == pq.read_schema(theirs).remove_metadata()
    assert b"pandas" in pq.read_table(mine).schema.metadata
    # Who wrote the file, and with which pandas, may differ.
    meta = json.loads(pq.ParquetFile(mine).metadata.metadata[b"pandas"])
    want = json.loads(pq.ParquetFile(theirs).metadata.metadata[b"pandas"])
    assert {k: v for k, v in meta.items() if k not in ("creator", "pandas_version")} == \
        {k: v for k, v in want.items() if k not in ("creator", "pandas_version")}


@pytest.mark.parametrize("rows,name", [
    ([{"a": dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc)}, {"a": dt.datetime(2020, 1, 1)}],
     "naive datetimes mixed"),
    ([{"a": dt.datetime(2020, 1, 1, tzinfo=dt.timezone(dt.timedelta(seconds=30)))}],
     "no name pyarrow writes"),
    ([{"a": {"k": 1}}], "dict"),
    ([{"a": True}, {"a": 1}], "bools mixed"),
    ([{"a": 2**64}], "int64"),
])
def test_writer_refuses_what_it_cannot_write(tmp_path, rows, name):
    with pytest.raises(parquet.ParquetError, match=name):
        parquet.write_records(str(tmp_path / "x.parquet"), rows)
    assert not os.listdir(tmp_path)
