"""Records: what the chip pipelines ask of a table, without pandas.

The JAX package keeps observations and grid chips in pandas DataFrames;
the port keeps them as lists of dicts, one per row, and this module does
the few table operations the pipelines need, with pandas' semantics where
an output depends on them:

* ``read_csv``: column types as ``pandas.read_csv`` infers them (int, else
  float, else str; an empty cell is NaN in a numeric column, else None),
  and its floats bit for bit: pandas' default parser is not correctly
  rounded (for many 17-digit values it differs from ``float()`` in the last
  bit), and an observation's coordinates decide its pixel;
* ``write_csv``: the bytes ``DataFrame.to_csv`` writes (minimal quoting,
  ``\\n`` line ends, an optional unnamed index column; a table with no
  columns is one empty line);
* ``group_by`` (keys in sorted order, rows in order), ``drop_duplicates``
  (the first or last row of each key, in row order), ``explode``;
* ``load_cached_records``: the chip creators' filtered-records cache,
  ``filtered_*_records.parquet`` as both packages write it (read by
  ``data/parquet.py``, no pyarrow), else the JSON that the port wrote
  before it wrote Parquet, so either package resumes the other's directory
  on any host.
"""

from __future__ import annotations

import csv
import io
import json
import math
import os
import re
from datetime import datetime, timedelta
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from instageo_tpu_torch.data.parquet import read_table

Record = Dict[str, Any]


_POW10 = [float(f"1e{k}") for k in range(309)]
_DECIMAL = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*$")


def pandas_float(s: str) -> float:
    """``s`` as ``pandas.read_csv``'s default float parser reads it: at most
    17 significant digits accumulated in double precision, then one
    multiplication or division by a power of ten. Other spellings (``nan``,
    ``inf``) go through ``float``."""
    m = _DECIMAL.match(s)
    if not m or not (m.group(2) or m.group(3)):
        return float(s)
    sign, whole, frac, exp = m.group(1), m.group(2), m.group(3) or "", m.group(4)
    number, exponent, digits = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in frac[:max(0, 17 - digits)]:
        number = number * 10.0 + (ord(ch) - 48)
        exponent -= 1
    if sign == "-":
        number = -number
    if exp:
        exponent += int(exp)
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return math.copysign(0.0, number)
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _parse_column(cells: List[str]) -> List[Any]:
    filled = [c for c in cells if c != ""]
    try:
        if len(filled) == len(cells):
            return [int(c) for c in cells]
    except ValueError:
        pass
    try:
        return [pandas_float(c) if c != "" else math.nan for c in cells]
    except ValueError:
        return [c if c != "" else None for c in cells]


def read_csv(path: str) -> Tuple[List[Record], List[str]]:
    """The rows of a CSV file and its columns. A file without a header gives
    no rows and no columns (where ``pandas.read_csv`` raises
    ``EmptyDataError``)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows or not any(rows[0]):
        return [], []
    columns, body = rows[0], rows[1:]
    for i, r in enumerate(body, 2):
        if len(r) != len(columns):
            raise ValueError(f"{path}:{i}: {len(r)} fields, the header has {len(columns)}")
    cols = {c: _parse_column([r[j] for r in body]) for j, c in enumerate(columns)}
    return [{c: cols[c][i] for c in columns} for i in range(len(body))], columns


def _cell(v: Any) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    if isinstance(v, float):
        return repr(v)
    return str(v)


def write_csv(path: str, rows: Sequence[Record], columns: Sequence[str],
              index: bool = False) -> None:
    """Write ``rows`` as ``DataFrame(rows, columns=columns).to_csv(path,
    index=index)`` does."""
    buf = io.StringIO()
    if not columns:
        buf.write("\n")
    else:
        w = csv.writer(buf, lineterminator="\n")
        w.writerow(([""] if index else []) + list(columns))
        for i, r in enumerate(rows):
            w.writerow(([i] if index else []) + [_cell(r.get(c)) for c in columns])
    with open(path, "w", newline="") as f:
        f.write(buf.getvalue())


def columns_of(*tables: Iterable[Record]) -> List[str]:
    """The union of the tables' keys in first-seen order (``pd.concat``)."""
    out: Dict[str, None] = {}
    for t in tables:
        for r in t:
            out.update(dict.fromkeys(r))
    return list(out)


def group_by(rows: Sequence[Record], key: str) -> Dict[Any, List[Record]]:
    """``{k: rows with row[key] == k}``, keys sorted, rows in order
    (``DataFrame.groupby``)."""
    groups: Dict[Any, List[Record]] = {}
    for r in rows:
        groups.setdefault(r[key], []).append(r)
    return {k: groups[k] for k in sorted(groups)}


def drop_duplicates(rows: Sequence[Record], key: str, keep: str = "first") -> List[Record]:
    """One row per ``row[key]``: the first or the last, in row order."""
    if keep not in ("first", "last"):
        raise ValueError(f"keep={keep!r}")
    pick: Dict[Any, int] = {}
    for i, r in enumerate(rows):
        if keep == "last" or r[key] not in pick:
            pick[r[key]] = i
    return [rows[i] for i in sorted(pick.values())]


def explode(rows: Sequence[Record], key: str) -> List[Record]:
    """One row per element of each row's list ``row[key]``."""
    return [{**r, key: v} for r in rows for v in r[key]]


def load_cached_records(parquet_path: str) -> Optional[List[Record]]:
    """The filtered records cached at ``parquet_path``, else in the JSON
    file of the same name (``{"datetime_columns": [...], "records": [...]}``,
    what the port wrote before it wrote Parquet); None where there is
    neither."""
    if os.path.exists(parquet_path):
        return read_table(parquet_path)
    json_path = os.path.splitext(parquet_path)[0] + ".json"
    if not os.path.exists(json_path):
        return None
    with open(json_path) as f:
        payload = json.load(f)
    rows = payload["records"]
    for r in rows:
        for c in payload["datetime_columns"]:
            if r.get(c) is not None:
                r[c] = datetime.fromisoformat(r[c])
    return rows


def to_datetime(value: Any) -> datetime:
    """A date as ``pd.to_datetime`` reads the ISO forms (``2023-06-16``,
    ``2023-06-16 10:30:00``, ``2023-06-16T10:30:00.5``, with or without an
    offset); anything else is refused."""
    if isinstance(value, datetime):
        return value
    try:
        return datetime.fromisoformat(str(value).strip().replace("Z", "+00:00"))
    except ValueError:
        raise ValueError(f"date {value!r} is not an ISO 8601 date or date and time") from None


def to_timedelta(value: Any) -> timedelta:
    """A time of day as ``pd.to_timedelta`` reads ``HH:MM[:SS[.f]]`` and
    ``N days HH:MM:SS``; anything else is refused."""
    s = str(value).strip()
    days = 0
    if "day" in s:
        head, _, s = s.partition("day")
        s = s.lstrip("s").strip()
        try:
            days = int(head.strip())
        except ValueError:
            raise ValueError(f"time {value!r} is not [N days] HH:MM[:SS]") from None
    parts = s.split(":")
    try:
        if len(parts) not in (2, 3):
            raise ValueError
        h, m = int(parts[0]), int(parts[1])
        sec = float(parts[2]) if len(parts) == 3 else 0.0
    except ValueError:
        raise ValueError(f"time {value!r} is not [N days] HH:MM[:SS]") from None
    return timedelta(days=days, hours=h, minutes=m, seconds=sec)

