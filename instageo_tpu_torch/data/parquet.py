"""Parquet without pyarrow: the observations and records caches of the chip
creators, read and written in Python over numpy, ``zlib`` and ``struct``.

The JAX CLIs read observations with ``pd.read_parquet`` and cache their
filtered records with ``DataFrame.to_parquet``; the port reads and writes
those files itself, so it needs neither pandas nor pyarrow on any host:

* ``read_table(path, columns, filters)``: the rows that
  ``pyarrow.parquet.read_table(path, filters=...).to_pylist()`` gives,
  except that a timestamp is a ``datetime`` (nanoseconds that are not
  whole microseconds are refused; one adjusted to UTC is in the zone the
  ``pandas`` metadata names, else in UTC), a null in a float column is NaN,
  and the saved pandas index columns are left out. Physical types BOOLEAN,
  INT32, INT64, INT96 (timestamps), FLOAT, DOUBLE and BYTE_ARRAY; logical
  types STRING/UTF8, TIMESTAMP (millis, micros, nanos), DATE, the signed
  and unsigned INT widths, the null type and LIST (3-level and legacy
  2-level, nulls at either level); PLAIN and dictionary encodings (a chunk
  may fall back from dictionary to plain); data pages v1 and v2; UNCOMPRESSED, SNAPPY
  (``snappy_decompress``, by hand) and GZIP. Anything else raises
  ``ParquetError`` naming the feature, never partial data.
* ``write_records(path, rows)``: the file ``DataFrame(rows).to_parquet``
  writes as far as ``pd.read_parquet`` can tell (the same columns, values
  and dtypes, the ``pandas`` metadata with its RangeIndex): one row group,
  PLAIN, uncompressed, written to a temporary file and renamed into place.
  A column of NaN only is float64 with every value null, one of None only
  has the null type; datetimes with a time zone are
  TIMESTAMP(isAdjustedToUTC=true, MICROS) with the zone in the ``pandas``
  metadata, which ``read_table`` gives back, and in the Arrow schema that
  pyarrow keeps under ``ARROW:schema``.

The Thrift compact protocol (``FileMetaData`` and ``PageHeader``) and the
RLE/bit-packed hybrid (levels, dictionary indices) are the shared pieces.
"""

from __future__ import annotations

import base64
import json
import math
import numbers
import os
import struct
import zlib
from datetime import datetime, timedelta, timezone, tzinfo
from typing import Any, Dict, List, Optional, Sequence, Tuple
from zoneinfo import ZoneInfo

import numpy as np

Record = Dict[str, Any]
MAGIC = b"PAR1"


class ParquetError(ValueError):
    """A file this module cannot read or write; the message names why."""


# --- the Thrift compact protocol -------------------------------------------

# Compact type ids.
T_TRUE, T_FALSE, T_BYTE, T_I16, T_I32, T_I64, T_DOUBLE, T_BINARY, T_LIST, T_SET, T_MAP, \
    T_STRUCT = range(1, 13)


class _Thrift:
    """A reader of compact-protocol values; a struct is ``{field id: value}``."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf, self.pos = buf, pos

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def value(self, ctype: int) -> Any:
        if ctype == T_TRUE:
            return True
        if ctype == T_FALSE:
            return False
        if ctype == T_BYTE:
            b = self.byte()
            return b - 256 if b > 127 else b
        if ctype in (T_I16, T_I32, T_I64):
            return self.zigzag()
        if ctype == T_DOUBLE:
            self.pos += 8
            return struct.unpack_from("<d", self.buf, self.pos - 8)[0]
        if ctype == T_BINARY:
            n = self.varint()
            self.pos += n
            if self.pos > len(self.buf):
                raise ParquetError("truncated Thrift metadata")
            return bytes(self.buf[self.pos - n:self.pos])
        if ctype in (T_LIST, T_SET):
            head = self.byte()
            n, etype = head >> 4, head & 15
            if n == 15:
                n = self.varint()
            if etype in (T_TRUE, T_FALSE):  # one byte per element
                return [self.byte() == 1 for _ in range(n)]
            return [self.value(etype) for _ in range(n)]
        if ctype == T_MAP:
            n = self.varint()
            if not n:
                return {}
            head = self.byte()
            out = {}
            for _ in range(n):
                k = self.value(head >> 4)
                out[k] = self.value(head & 15)
            return out
        if ctype == T_STRUCT:
            return self.struct()
        raise ParquetError(f"Thrift compact type {ctype}")

    def struct(self) -> Dict[int, Any]:
        out: Dict[int, Any] = {}
        last = 0
        while True:
            head = self.byte()
            if head == 0:
                return out
            delta, ctype = head >> 4, head & 15
            fid = last + delta if delta else self.zigzag()
            out[fid] = self.value(ctype)
            last = fid


def _put_varint(out: bytearray, n: int) -> None:
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _put_value(out: bytearray, ctype: int, v: Any) -> None:
    if ctype in (T_I16, T_I32, T_I64):
        _put_varint(out, (v << 1) ^ (v >> 63))
    elif ctype == T_BINARY:
        b = v.encode() if isinstance(v, str) else v
        _put_varint(out, len(b))
        out += b
    elif ctype == T_LIST:
        etype, items = v
        out.append((min(len(items), 15) << 4) | etype)
        if len(items) >= 15:
            _put_varint(out, len(items))
        for item in items:
            _put_value(out, etype, item)
    elif ctype == T_STRUCT:
        _put_struct(out, v)
    else:
        raise ParquetError(f"writing Thrift compact type {ctype}")


def _put_struct(out: bytearray, fields: Sequence[Tuple[int, int, Any]]) -> None:
    """``fields``: ``(field id, compact type, value)`` in id order; a value
    of None is left out, a bool is given as ``T_TRUE``; a list's value is
    ``(element type, items)``."""
    last = 0
    for fid, ctype, v in fields:
        if v is None:
            continue
        if ctype == T_TRUE:
            ctype = T_TRUE if v else T_FALSE
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | ctype)
        else:
            out.append(ctype)
            _put_varint(out, (fid << 1) ^ (fid >> 63))
        if ctype not in (T_TRUE, T_FALSE):
            _put_value(out, ctype, v)
        last = fid
    out.append(0)


# --- the format's enums ------------------------------------------------------

BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY = range(8)
TYPE_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE", "BYTE_ARRAY",
              "FIXED_LEN_BYTE_ARRAY")
REQUIRED, OPTIONAL, REPEATED = range(3)
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
                  5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
                  7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
CODEC_NAMES = ("UNCOMPRESSED", "SNAPPY", "GZIP", "LZO", "BROTLI", "LZ4", "ZSTD", "LZ4_RAW")
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)
# Converted types.
UTF8, MAP, MAP_KEY_VALUE, LIST, ENUM, DECIMAL, DATE, TIME_MILLIS, TIME_MICROS, \
    TIMESTAMP_MILLIS, TIMESTAMP_MICROS, UINT_8, UINT_16, UINT_32, UINT_64, INT_8, INT_16, \
    INT_32, INT_64 = range(19)
CONVERTED_NAMES = ("UTF8", "MAP", "MAP_KEY_VALUE", "LIST", "ENUM", "DECIMAL", "DATE",
                   "TIME_MILLIS", "TIME_MICROS", "TIMESTAMP_MILLIS", "TIMESTAMP_MICROS",
                   "UINT_8", "UINT_16", "UINT_32", "UINT_64", "INT_8", "INT_16", "INT_32",
                   "INT_64", "JSON", "BSON", "INTERVAL")
# LogicalType union members.
LOGICAL_NAMES = {1: "STRING", 2: "MAP", 3: "LIST", 4: "ENUM", 5: "DECIMAL", 6: "DATE",
                 7: "TIME", 8: "TIMESTAMP", 10: "INTEGER", 11: "UNKNOWN", 12: "JSON",
                 13: "BSON", 14: "UUID", 15: "FLOAT16", 16: "VARIANT", 17: "GEOMETRY",
                 18: "GEOGRAPHY"}
_UNIX_JULIAN_DAY = 2440588


# --- Snappy ------------------------------------------------------------------

def snappy_decompress(data: bytes) -> bytes:
    """A raw Snappy block (the format Parquet pages use) decompressed."""
    src = memoryview(data)
    pos = n = shift = 0
    while True:
        b = src[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if b < 0x80:
            break
        shift += 7
    out = bytearray()
    end = len(src)
    while pos < end:
        tag = src[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = tag >> 2
            if length >= 60:
                extra = length - 59
                length = int.from_bytes(src[pos:pos + extra], "little")
                pos += extra
            length += 1
            if pos + length > end:
                raise ParquetError("corrupt Snappy data: a literal runs past the end")
            out += src[pos:pos + length]
            pos += length
            continue
        if kind == 1:
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | src[pos]
            pos += 1
        elif kind == 2:
            length = (tag >> 2) + 1
            offset = src[pos] | (src[pos + 1] << 8)
            pos += 2
        else:
            length = (tag >> 2) + 1
            offset = int.from_bytes(src[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ParquetError("corrupt Snappy data: a copy reaches before the start")
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:  # the copy overlaps what it writes: the last `offset` bytes repeat
            chunk = bytes(out[start:])
            reps, rest = divmod(length, offset)
            out += chunk * reps + chunk[:rest]
    if len(out) != n:
        raise ParquetError(f"corrupt Snappy data: {len(out)} bytes, the header says {n}")
    return bytes(out)


def _decompress(page: bytes, codec: int, size: int) -> bytes:
    if codec == 0:
        return page
    if codec == 1:
        out = snappy_decompress(page)
    elif codec == 2:
        out = zlib.decompressobj(wbits=47).decompress(page)  # gzip or zlib header
    else:
        name = CODEC_NAMES[codec] if codec < len(CODEC_NAMES) else str(codec)
        raise ParquetError(f"compression codec {name} is not supported (UNCOMPRESSED, "
                           "SNAPPY and GZIP are)")
    if len(out) != size:
        raise ParquetError(f"a page decompressed to {len(out)} bytes, its header says {size}")
    return out


# --- the RLE / bit-packed hybrid ---------------------------------------------

def _rle_hybrid(buf: bytes, pos: int, end: int, width: int, count: int) -> np.ndarray:
    """``count`` values of ``width`` bits from the hybrid runs in
    ``buf[pos:end]``."""
    out = np.zeros(count, np.int64)
    if width == 0 or count == 0:
        return out
    nbytes = (width + 7) // 8
    weights = np.left_shift(np.int64(1), np.arange(width, dtype=np.int64))
    i = 0
    while i < count:
        if pos >= end:
            raise ParquetError("truncated RLE/bit-packed levels or indices")
        header = shift = 0
        while True:
            b = buf[pos]
            pos += 1
            header |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
        if header & 1:  # bit-packed: groups of 8 values
            groups = header >> 1
            size = groups * width
            if pos + size > end:
                raise ParquetError("truncated bit-packed run")
            bits = np.unpackbits(np.frombuffer(buf, np.uint8, size, pos), bitorder="little")
            pos += size
            vals = bits.reshape(-1, width).astype(np.int64) @ weights
            take = min(groups * 8, count - i)
            out[i:i + take] = vals[:take]
        else:  # one value repeated
            take = min(header >> 1, count - i)
            out[i:i + take] = int.from_bytes(buf[pos:pos + nbytes], "little")
            pos += nbytes
        i += take
    return out


def _rle_encode(values: np.ndarray, width: int) -> bytes:
    """``values`` as RLE runs of the hybrid (one run per run of equal
    values)."""
    out = bytearray()
    nbytes = (width + 7) // 8
    if not len(values):
        return bytes(out)
    edges = np.flatnonzero(np.diff(values)) + 1
    starts = np.concatenate([[0], edges])
    ends = np.concatenate([edges, [len(values)]])
    for s, e in zip(starts.tolist(), ends.tolist()):
        _put_varint(out, (e - s) << 1)
        out += int(values[s]).to_bytes(nbytes, "little")
    return bytes(out)


def _length_prefixed(b: bytes) -> bytes:
    return struct.pack("<I", len(b)) + b


# --- the schema --------------------------------------------------------------

class _Leaf:
    """A top-level column: its leaf's physical and logical type, its levels
    and, for a list, the definition levels at which the list and its
    elements are defined."""

    def __init__(self, name: str, leaf: Dict[int, Any], max_def: int, max_rep: int,
                 list_def: Optional[int] = None, item_def: Optional[int] = None):
        self.name = name
        self.max_def, self.max_rep = max_def, max_rep
        self.list_def, self.item_def = list_def, item_def
        self.physical = leaf.get(1)
        self.convert = _converter(name, leaf)

    @property
    def is_float(self) -> bool:
        return self.max_rep == 0 and self.physical in (FLOAT, DOUBLE)


def _schema_tree(elements: List[Dict[int, Any]]) -> List[Tuple[Dict[int, Any], list]]:
    """The root's children as ``(element, children)`` trees."""
    pos = 1

    def node():
        nonlocal pos
        el = elements[pos]
        pos += 1
        return el, [node() for _ in range(el.get(5, 0))]

    return [node() for _ in range(elements[0].get(5, 0))]


def _name(el: Dict[int, Any]) -> str:
    return el[4].decode()


def _columns(elements: List[Dict[int, Any]]) -> List[_Leaf]:
    out = []
    for el, children in _schema_tree(elements):
        name = _name(el)
        rep = el.get(3, REQUIRED)
        top_def = int(rep != REQUIRED)
        if not children:
            if rep == REPEATED:
                raise ParquetError(f"column {name!r}: a repeated field outside a LIST is not "
                                   "supported")
            out.append(_Leaf(name, el, top_def, 0))
            continue
        if el.get(6) != LIST and 3 not in el.get(10, {}):
            what = "MAP" if el.get(6) in (MAP, MAP_KEY_VALUE) or 2 in el.get(10, {}) else "struct"
            raise ParquetError(f"column {name!r}: nested {what} columns are not supported")
        if len(children) != 1 or children[0][0].get(3) != REPEATED:
            raise ParquetError(f"column {name!r}: a LIST whose child is not one repeated field")
        mid, grand = children[0]
        rep_def = top_def + 1
        if not grand:  # legacy 2-level: the repeated field is the element
            out.append(_Leaf(name, mid, rep_def, 1, top_def, rep_def))
            continue
        leaf = grand[0][0]
        if leaf.get(3) == REPEATED or leaf.get(6) == LIST or 3 in leaf.get(10, {}):
            raise ParquetError(f"column {name!r}: a LIST of lists is not supported")
        if len(grand) != 1 or grand[0][1] or _name(mid) in ("array", name + "_tuple"):
            raise ParquetError(f"column {name!r}: a LIST of structs is not supported")
        out.append(_Leaf(name, leaf, rep_def + int(leaf.get(3, REQUIRED) != REQUIRED), 1,
                         top_def, rep_def))
    return out


def _converter(name: str, el: Dict[int, Any]):
    """A function from a column's decoded values (a numpy array) to Python
    values, as pyarrow's ``to_pylist`` gives them (a timestamp as a
    ``datetime``)."""
    physical, conv, logical = el.get(1), el.get(6), el.get(10, {})
    kind = next(iter(logical), None)
    where = f"column {name!r}"
    if kind in (5, 7, 12, 13, 14, 15, 16, 17, 18, 2, 4) or conv in (
            DECIMAL, TIME_MILLIS, TIME_MICROS, ENUM, 19, 20, 21):
        what = LOGICAL_NAMES.get(kind) if kind is not None else CONVERTED_NAMES[conv]
        raise ParquetError(f"{where}: logical type {what} is not supported")
    if physical == FIXED_LEN_BYTE_ARRAY:
        raise ParquetError(f"{where}: physical type FIXED_LEN_BYTE_ARRAY is not supported")
    if physical == BOOLEAN or physical in (FLOAT, DOUBLE):
        return lambda v: v.tolist()
    if physical == BYTE_ARRAY:
        if kind == 1 or conv == UTF8:
            return lambda v: [b.decode("utf-8") for b in v]
        return lambda v: list(v)
    if physical == INT96:
        return lambda v: _datetimes(v, 1_000_000_000, None, where)
    if kind == 6 or conv == DATE:
        return lambda v: v.astype("datetime64[D]").astype(object).tolist()
    if kind == 8 or conv in (TIMESTAMP_MILLIS, TIMESTAMP_MICROS):
        if kind == 8:
            utc = bool(logical[8].get(1))
            per_s = {1: 1000, 2: 1_000_000, 3: 1_000_000_000}[next(iter(logical[8][2]))]
        else:
            utc, per_s = True, 1000 if conv == TIMESTAMP_MILLIS else 1_000_000
        return lambda v: _datetimes(v, per_s, timezone.utc if utc else None, where)
    unsigned = (kind == 10 and not logical[10].get(2, True)) or conv in (
        UINT_8, UINT_16, UINT_32, UINT_64)
    if unsigned:
        return lambda v: v.view(np.uint32 if physical == INT32 else np.uint64).tolist()
    return lambda v: v.tolist()


def _datetimes(v: np.ndarray, per_s: int, tz, where: str) -> List[datetime]:
    if per_s == 1000:
        us = v.astype(np.int64) * 1000
    elif per_s == 1_000_000_000:
        if (v % 1000).any():
            raise ParquetError(f"{where}: a timestamp with nanoseconds that are not whole "
                               "microseconds")
        us = v // 1000
    else:
        us = v
    out = us.astype("datetime64[us]").astype(object).tolist()
    return [d.replace(tzinfo=tz) for d in out] if tz is not None else out


# --- pages -------------------------------------------------------------------

def _plain(buf: bytes, pos: int, physical: int, count: int, where: str):
    """``count`` PLAIN values from ``buf[pos:]``: a numpy array (BYTE_ARRAY:
    of ``bytes`` objects)."""
    if physical == BYTE_ARRAY:
        out = np.empty(count, object)
        for i in range(count):
            n = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
            out[i] = bytes(buf[pos:pos + n])
            pos += n
        if pos > len(buf):
            raise ParquetError(f"{where}: truncated BYTE_ARRAY values")
        return out
    if physical == BOOLEAN:
        raw = np.frombuffer(buf, np.uint8, (count + 7) // 8, pos)
        return np.unpackbits(raw, bitorder="little")[:count].astype(bool)
    if physical == INT96:
        raw = np.frombuffer(buf, np.dtype([("ns", "<i8"), ("day", "<i4")]), count, pos)
        return ((raw["day"].astype(np.int64) - _UNIX_JULIAN_DAY) * 86_400_000_000_000
                + raw["ns"])
    dtype = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}.get(physical)
    if dtype is None:
        raise ParquetError(f"{where}: physical type {TYPE_NAMES[physical]} is not supported")
    return np.frombuffer(buf, dtype, count, pos)


def _levels_v1(buf: bytes, pos: int, encoding: int, max_level: int, count: int,
               where: str) -> Tuple[np.ndarray, int]:
    if encoding != RLE:
        raise ParquetError(f"{where}: level encoding {ENCODING_NAMES.get(encoding, encoding)} "
                           "is not supported")
    n = int.from_bytes(buf[pos:pos + 4], "little")
    return _rle_hybrid(buf, pos + 4, pos + 4 + n, max_level.bit_length(), count), pos + 4 + n


def _values(buf: bytes, pos: int, encoding: int, col: _Leaf, count: int, dictionary,
            where: str):
    if encoding == PLAIN:
        return _plain(buf, pos, col.physical, count, where)
    if encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
        if dictionary is None:
            raise ParquetError(f"{where}: a dictionary-encoded page without a dictionary page")
        if count == 0:
            return dictionary[:0]
        idx = _rle_hybrid(buf, pos + 1, len(buf), buf[pos], count)
        if len(idx) and (idx.max() >= len(dictionary)):
            raise ParquetError(f"{where}: a dictionary index past the dictionary")
        return dictionary[idx]
    if encoding == RLE and col.physical == BOOLEAN:
        n = int.from_bytes(buf[pos:pos + 4], "little")
        return _rle_hybrid(buf, pos + 4, pos + 4 + n, 1, count).astype(bool)
    raise ParquetError(f"{where}: encoding {ENCODING_NAMES.get(encoding, encoding)} is not "
                       "supported (PLAIN and the dictionary encodings are)")


def _read_chunk(buf: bytes, chunk: Dict[int, Any], col: _Leaf, where: str):
    """A column chunk's values (non-null only, decoded), definition and
    repetition levels."""
    meta = chunk.get(3)
    if meta is None or chunk.get(1):
        raise ParquetError(f"{where}: a column chunk in another file is not supported")
    codec, total_values = meta[4], meta[5]
    start = meta[9]
    if meta.get(11):  # the dictionary page comes first
        start = min(start, meta[11])
    pos, end = start, start + meta[7]
    dictionary = None
    values, defs, reps = [], [], []
    seen = 0
    while seen < total_values:
        if pos >= end:
            raise ParquetError(f"{where}: the pages hold {seen} of {total_values} values")
        t = _Thrift(buf, pos)
        header = t.struct()
        pos = t.pos
        ptype, usize, csize = header[1], header[2], header[3]
        page = buf[pos:pos + csize]
        pos += csize
        if ptype == DICTIONARY_PAGE:
            dh = header[7]
            if dh.get(2, PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                raise ParquetError(f"{where}: dictionary page encoding "
                                   f"{ENCODING_NAMES.get(dh[2], dh[2])} is not supported")
            dictionary = _plain(_decompress(page, codec, usize), 0, col.physical, dh[1], where)
            continue
        if ptype == DATA_PAGE:
            dh = header[5]
            n = dh[1]
            data = _decompress(page, codec, usize)
            p = 0
            rep = np.zeros(n, np.int64)
            if col.max_rep:
                rep, p = _levels_v1(data, p, dh.get(4, RLE), col.max_rep, n, where)
            dfn = np.full(n, col.max_def, np.int64)
            if col.max_def:
                dfn, p = _levels_v1(data, p, dh.get(3, RLE), col.max_def, n, where)
            encoding = dh[2]
        elif ptype == DATA_PAGE_V2:
            dh = header[8]
            n, dlen, rlen = dh[1], dh[5], dh[6]
            rep = (_rle_hybrid(page, 0, rlen, col.max_rep.bit_length(), n) if col.max_rep
                   else np.zeros(n, np.int64))
            dfn = (_rle_hybrid(page, rlen, rlen + dlen, col.max_def.bit_length(), n)
                   if col.max_def else np.full(n, col.max_def, np.int64))
            data = page[rlen + dlen:]
            if dh.get(7, True):
                data = _decompress(data, codec, usize - rlen - dlen)
            p, encoding = 0, dh[4]
        elif ptype == INDEX_PAGE:
            continue
        else:
            raise ParquetError(f"{where}: page type {ptype} is not supported")
        count = int((dfn == col.max_def).sum())
        values.append(_values(data, p, encoding, col, count, dictionary, where))
        defs.append(dfn)
        reps.append(rep)
        seen += n
    if not values:
        return np.empty(0), np.empty(0, np.int64), np.empty(0, np.int64)
    return np.concatenate(values), np.concatenate(defs), np.concatenate(reps)


def _assemble(col: _Leaf, values: list, defs: np.ndarray, reps: np.ndarray) -> list:
    """The column's rows: values where defined, None where null, lists
    rebuilt from the levels."""
    if col.max_rep == 0:
        if col.max_def == 0:
            return values
        out: List[Any] = [None] * len(defs)
        for i, v in zip(np.flatnonzero(defs == col.max_def).tolist(), values):
            out[i] = v
        return out
    rows: List[Any] = []
    it = iter(values)
    cur: Optional[list] = None
    for d, r in zip(defs.tolist(), reps.tolist()):
        if r == 0:
            if d < col.list_def:
                rows.append(None)
                continue
            cur = []
            rows.append(cur)
            if d < col.item_def:
                continue  # an empty list
        cur.append(next(it) if d == col.max_def else None)
    return rows


# --- filters -------------------------------------------------------------------

_OPS = {
    "=": lambda a, b: a == b, "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, ">": lambda a, b: a > b, "<=": lambda a, b: a <= b,
    ">=": lambda a, b: a >= b, "in": lambda a, b: a in b, "not in": lambda a, b: a not in b,
}


def _keep(v: Any, op: str, value: Any) -> bool:
    """Whether a row whose column holds ``v`` passes ``(op, value)`` as a
    pyarrow dataset filter keeps it: a null passes ``not in`` only (a null
    compares to null, which drops the row; ``isin`` gives false)."""
    if v is None:
        return op == "not in" and None not in value
    return bool(_OPS[op](v, value))


# --- reading -----------------------------------------------------------------

def _footer(buf: bytes, path: str) -> Dict[int, Any]:
    if len(buf) < 12 or buf[:4] != MAGIC or buf[-4:] != MAGIC:
        raise ParquetError(f"{path} is not a Parquet file (or is encrypted)")
    n = int.from_bytes(buf[-8:-4], "little")
    if n + 12 > len(buf):
        raise ParquetError(f"{path}: a footer of {n} bytes in a file of {len(buf)}")
    return _Thrift(buf, len(buf) - 8 - n).struct()


def _key_value(meta: Dict[int, Any]) -> Dict[str, str]:
    return {kv[1].decode(): kv.get(2, b"").decode() for kv in meta.get(5, [])}


def read_table(path: str, columns: Optional[Sequence[str]] = None,
               filters: Optional[Sequence[Tuple[str, str, Any]]] = None) -> List[Record]:
    """The rows of the Parquet file ``path`` as dicts (see the module's
    docstring): ``columns`` picks and orders the columns; ``filters``, flat
    ``(column, op, value)`` triples ANDed, keeps the rows that
    ``pyarrow.parquet.read_table(path, filters=filters)`` keeps."""
    with open(path, "rb") as f:
        buf = f.read()
    meta = _footer(buf, path)
    if 8 in meta:
        raise ParquetError(f"{path}: encrypted files are not supported")
    cols = {c.name: c for c in _columns(meta[2])}
    frame_meta = json.loads(_key_value(meta).get("pandas") or "{}")
    index = {c for c in frame_meta.get("index_columns", []) if isinstance(c, str)}
    zones = {c.get("field_name"): _zone(c["metadata"]["timezone"])
             for c in frame_meta.get("columns", [])
             if isinstance(c.get("metadata"), dict) and "timezone" in c["metadata"]}
    names = [c for c in cols if c not in index] if columns is None else list(columns)
    filters = list(filters or [])
    for f in filters:
        if not (isinstance(f, (tuple, list)) and len(f) == 3 and isinstance(f[0], str)):
            raise ParquetError(f"filter {f!r}: only flat (column, op, value) triples are "
                               "supported")
        if f[1] not in _OPS:
            raise ParquetError(f"filter {f!r}: op {f[1]!r} is not one of {sorted(_OPS)}")
        if f[1] in ("in", "not in") and isinstance(f[2], (str, bytes)):
            raise ParquetError(f"filter {f!r}: {f[1]!r} needs a collection of values")
    wanted = list(dict.fromkeys(names + [f[0] for f in filters]))
    missing = [c for c in wanted if c not in cols]
    if missing:
        raise ParquetError(f"{path}: no column {missing[0]!r} (it has {list(cols)})")
    position = {c.name: i for i, c in enumerate(cols.values())}
    table: Dict[str, list] = {c: [] for c in wanted}
    for g, group in enumerate(meta.get(4, [])):
        chunks = group[1]
        for name in wanted:
            col = cols[name]
            where = f"{path}: column {name!r} (row group {g})"
            values, defs, reps = _read_chunk(buf, chunks[position[name]], col, where)
            rows = _assemble(col, col.convert(values) if len(values) else [], defs, reps)
            if name in zones:  # pyarrow's type holds the zone pandas saved
                rows = [v.astimezone(zones[name]) if isinstance(v, datetime) and v.tzinfo
                        else v for v in rows]
            if len(rows) != group[3]:
                raise ParquetError(f"{where}: {len(rows)} rows, the row group has {group[3]}")
            table[name].extend(rows)
    n = sum(group[3] for group in meta.get(4, []))
    keep = range(n)
    for name, op, value in filters:
        vals = table[name]
        keep = [i for i in keep if _keep(vals[i], op, value)]
    floats = {name for name in names if cols[name].is_float}
    out = []
    for i in keep:
        row = {}
        for name in names:
            v = table[name][i]
            row[name] = math.nan if v is None and name in floats else v
        out.append(row)
    return out


# --- writing -----------------------------------------------------------------

_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)
_US = timedelta(microseconds=1)


def _zone(name: str) -> tzinfo:
    """A time zone from the name pyarrow gives it: ``UTC``, ``+HH:MM`` or a
    zone key."""
    if name == "UTC":
        return timezone.utc
    if len(name) == 6 and name[0] in "+-" and name[3] == ":":
        offset = timedelta(hours=int(name[1:3]), minutes=int(name[4:6]))
        return timezone(-offset if name[0] == "-" else offset)
    return ZoneInfo(name)


def _zone_name(tz: tzinfo, where: str) -> str:
    """The name pyarrow writes for ``tz`` (the inverse of ``_zone``)."""
    if getattr(tz, "key", None):
        return tz.key
    if tz is timezone.utc:
        return "UTC"
    if isinstance(tz, timezone):
        offset = tz.utcoffset(None)
        minutes, rest = divmod(abs(offset), timedelta(minutes=1))
        if not rest:
            sign = "-" if offset < timedelta(0) else "+"
            return f"{sign}{minutes // 60:02d}:{minutes % 60:02d}"
    raise ParquetError(f"{where}: time zone {tz!r} has no name pyarrow writes")


def _is_null(v: Any) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _scalar_kind(vals: List[Any], where: str) -> str:
    """The type pandas infers for non-null Python values: int64, float64,
    bool, datetime (naive), datetimetz (with a time zone) or str."""
    if all(isinstance(v, (bool, np.bool_)) for v in vals):
        return "bool"
    if any(isinstance(v, (bool, np.bool_)) for v in vals):
        raise ParquetError(f"{where}: bools mixed with other values")
    if all(isinstance(v, numbers.Integral) for v in vals):
        if any(not -2**63 <= int(v) < 2**63 for v in vals):
            raise ParquetError(f"{where}: an int outside int64")
        return "int64"
    if all(isinstance(v, numbers.Real) for v in vals):
        return "float64"
    if all(isinstance(v, datetime) for v in vals):
        aware = sum(v.tzinfo is not None for v in vals)
        if 0 < aware < len(vals):
            raise ParquetError(f"{where}: naive datetimes mixed with datetimes with a time "
                               "zone")
        return "datetimetz" if aware else "datetime"
    if all(isinstance(v, str) for v in vals):
        return "str"
    kinds = sorted({type(v).__name__ for v in vals})
    raise ParquetError(f"{where}: values of type {', '.join(kinds)} are not supported")


def _column_kind(values: List[Any], where: str) -> Tuple[str, Optional[str]]:
    """``(kind, element kind)``: a list column's kind is ``list``."""
    present = [v for v in values if not _is_null(v)]
    if not present:  # pandas: NaN makes float64, None alone the null type
        return ("float64" if any(isinstance(v, float) for v in values) else "null"), None
    if any(isinstance(v, (list, tuple, np.ndarray)) for v in present):
        if not all(isinstance(v, (list, tuple, np.ndarray)) for v in present):
            raise ParquetError(f"{where}: lists mixed with other values")
        items = [x for v in present for x in v if not _is_null(x)]
        elem = _scalar_kind(items, where) if items else "float64"
        if elem not in ("int64", "float64"):
            raise ParquetError(f"{where}: lists of {elem} are not supported")
        return "list", elem
    kind = _scalar_kind(present, where)
    if kind == "int64" and len(present) < len(values):
        kind = "float64"  # pandas: ints with a missing value are float64
    if kind == "bool" and len(present) < len(values):
        raise ParquetError(f"{where}: a bool column with nulls is not supported")
    return kind, None


_PHYSICAL = {"int64": INT64, "float64": DOUBLE, "bool": BOOLEAN, "datetime": INT64,
             "datetimetz": INT64, "str": BYTE_ARRAY, "null": INT32}
_PANDAS_TYPES = {"int64": ("int64", "int64"), "float64": ("float64", "float64"),
                 "bool": ("bool", "bool"), "datetime": ("datetime", "datetime64[us]"),
                 "datetimetz": ("datetimetz", "datetime64[us]"), "str": ("object", "str"),
                 "null": ("empty", "object")}


def _plain_bytes(kind: str, vals: List[Any]) -> bytes:
    if kind == "int64":
        return np.asarray(vals, "<i8").tobytes()
    if kind == "float64":
        return np.asarray(vals, "<f8").tobytes()
    if kind == "bool":
        return np.packbits(np.asarray(vals, bool), bitorder="little").tobytes()
    if kind == "datetime":
        return np.asarray(vals, "datetime64[us]").astype("<i8").tobytes()
    if kind == "datetimetz":
        return np.asarray([(v - _EPOCH) // _US for v in vals], "<i8").tobytes()
    parts = []
    for v in vals:
        b = v.encode("utf-8")
        parts += (struct.pack("<I", len(b)), b)
    return b"".join(parts)


# --- the Arrow schema pyarrow keeps beside the Parquet one ----------------------
#
# pyarrow saves the frame's Arrow schema, base64 of an IPC Schema message,
# under the key ``ARROW:schema``; a time zone other than UTC is kept only
# there (Parquet's TIMESTAMP knows only whether it is adjusted to UTC).

class _Flat:
    """A FlatBuffers writer that lays each table out before what it points
    to, so that every offset is positive. A table is ``[(slot, kind,
    value)]``: kind ``"u8"``, ``"i16"``, ``"i32"``, ``"str"``, ``"table"``
    or ``"tables"`` (a vector of tables)."""

    SIZES = {"u8": 1, "i16": 2, "i32": 4}

    def __init__(self):
        self.buf = bytearray()

    def _pad(self, n: int) -> None:
        self.buf += bytes(-len(self.buf) % n)

    def _u32_at(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def _child(self, at: int, kind: str, value: Any) -> None:
        self._pad(4)
        if kind == "str":
            b = value.encode()
            self._u32_at(at, len(self.buf))
            self.buf += struct.pack("<I", len(b)) + b + b"\0"
        elif kind == "table":
            self._u32_at(at, self.table(value))
        else:  # a vector of tables
            self._u32_at(at, len(self.buf))
            self.buf += struct.pack("<I", len(value))
            slots = len(self.buf)
            self.buf += bytes(4 * len(value))
            for i, t in enumerate(value):
                self._u32_at(slots + 4 * i, self.table(t))

    def table(self, fields: Sequence[Tuple[int, str, Any]]) -> int:
        """Write a table (its vtable first) and what it points to; its
        position."""
        layout, size = [], 4
        for slot, kind, value in sorted(fields, key=lambda f: -self.SIZES.get(f[1], 4)):
            width = self.SIZES.get(kind, 4)
            size += -size % width
            layout.append((slot, kind, value, size))
            size += width
        vtable = [0] * (max((f[0] for f in fields), default=-1) + 1)
        for slot, _, _, at in layout:
            vtable[slot] = at
        self._pad(2)
        vt = len(self.buf)
        self.buf += struct.pack(f"<{2 + len(vtable)}H", 4 + 2 * len(vtable), size, *vtable)
        self._pad(8)
        start = len(self.buf)
        self.buf += struct.pack("<i", start - vt) + bytes(size - 4)
        for _, kind, value, at in layout:
            if kind in self.SIZES:
                struct.pack_into("<" + {"u8": "B", "i16": "h", "i32": "i"}[kind], self.buf,
                                 start + at, value)
        for _, kind, value, at in layout:
            if kind not in self.SIZES:
                self._child(start + at, kind, value)
        return start

    def root(self, fields) -> bytes:
        self.buf = bytearray(8)  # the root offset, padded
        self._u32_at(0, self.table(fields))
        self._pad(8)
        return bytes(self.buf)


# Arrow's Type union: Null, Int, FloatingPoint, Bool, Timestamp, List, LargeUtf8.
_ARROW_TYPES = {"null": (1, []), "int64": (2, [(0, "i32", 64), (1, "u8", 1)]),
                "float64": (3, [(0, "i16", 2)]), "bool": (6, []), "str": (20, [])}


def _arrow_field(name: str, kind: str, elem: Optional[str], zone: Optional[str]) -> list:
    children = []
    if kind == "list":
        type_id, type_fields = 12, []
        children = [_arrow_field("item", elem, None, None)]
    elif kind in ("datetime", "datetimetz"):  # unit MICROSECOND
        type_id, type_fields = 10, [(0, "i16", 2)] + ([(1, "str", zone)] if zone else [])
    else:
        type_id, type_fields = _ARROW_TYPES[kind]
    return [(0, "str", name), (1, "u8", 1), (2, "u8", type_id), (3, "table", type_fields),
            (5, "tables", children)]


def _arrow_schema(fields: List[list], frame_meta: str) -> str:
    """``ARROW:schema``: an IPC message (V5, a Schema of ``fields`` with the
    ``pandas`` metadata, which pyarrow then reads from here) with its
    continuation marker and length, in base64."""
    pandas_kv = [(0, "str", "pandas"), (1, "str", frame_meta)]
    flat = _Flat().root([(0, "i16", 4), (1, "u8", 1),
                         (2, "table", [(1, "tables", fields), (2, "tables", [pandas_kv])])])
    return base64.b64encode(struct.pack("<Ii", 0xFFFFFFFF, len(flat)) + flat).decode()


def _logical(kind: str, el: list) -> list:
    """Schema element fields for a leaf of ``kind``."""
    if kind == "str":
        el += [(6, T_I32, UTF8), (10, T_STRUCT, [(1, T_STRUCT, [])])]
    elif kind in ("datetime", "datetimetz"):  # TIMESTAMP(isAdjustedToUTC, MICROS)
        utc = kind == "datetimetz"
        el += [(6, T_I32, TIMESTAMP_MICROS if utc else None),
               (10, T_STRUCT, [(8, T_STRUCT, [(1, T_TRUE, utc),
                                              (2, T_STRUCT, [(2, T_STRUCT, [])])])])]
    elif kind == "null":
        el += [(10, T_STRUCT, [(11, T_STRUCT, [])])]
    return el


def write_records(path: str, rows: Sequence[Record]) -> None:
    """Write ``rows`` as ``pd.DataFrame(rows).to_parquet(path)`` would, as
    far as ``pd.read_parquet`` can tell (see the module's docstring)."""
    names: Dict[str, None] = {}
    for r in rows:
        names.update(dict.fromkeys(r))
    n = len(rows)
    schema = [[(3, T_I32, REQUIRED), (4, T_BINARY, "schema"), (5, T_I32, len(names))]]
    body = bytearray(MAGIC)
    chunks, frame_cols, arrow_fields = [], [], []
    total = 0
    for name in names:
        where = f"column {name!r}"
        values = [r.get(name) for r in rows]
        zone = elem = None
        kind, elem = _column_kind(values, where)
        present = np.asarray([not _is_null(v) for v in values], np.int64)
        if kind == "list":
            reps, defs, items = [], [], []
            for v, ok in zip(values, present):
                if not ok:
                    reps.append(0)
                    defs.append(0)
                    continue
                if not len(v):
                    reps.append(0)
                    defs.append(1)
                    continue
                for j, x in enumerate(v):
                    reps.append(int(j > 0))
                    if _is_null(x):
                        defs.append(2)
                    else:
                        defs.append(3)
                        items.append(x if elem == "int64" else float(x))
            levels = (_length_prefixed(_rle_encode(np.asarray(reps), 1))
                      + _length_prefixed(_rle_encode(np.asarray(defs), 2)))
            raw = levels + _plain_bytes(elem, items)
            leaf_kind, count = elem, len(defs)
            schema += [
                [(3, T_I32, OPTIONAL), (4, T_BINARY, name), (5, T_I32, 1), (6, T_I32, LIST),
                 (10, T_STRUCT, [(3, T_STRUCT, [])])],
                [(3, T_I32, REPEATED), (4, T_BINARY, "list"), (5, T_I32, 1)],
                [(1, T_I32, _PHYSICAL[elem]), (3, T_I32, OPTIONAL), (4, T_BINARY, "element")],
            ]
            path_in_schema = [name, "list", "element"]
            dtypes = (f"list[{elem}]", "object")
        else:
            vals = [v for v, ok in zip(values, present) if ok]
            if kind == "float64":
                vals = [float(v) for v in vals]
            raw = _length_prefixed(_rle_encode(present, 1)) + _plain_bytes(kind, vals)
            leaf_kind, count = kind, n
            schema.append(_logical(kind, [(1, T_I32, _PHYSICAL[kind]), (3, T_I32, OPTIONAL),
                                          (4, T_BINARY, name)]))
            path_in_schema = [name]
            dtypes = _PANDAS_TYPES[kind]
            if kind == "datetimetz":  # pandas: the first value's zone
                zone = {"timezone": _zone_name(vals[0].tzinfo, where)}
        arrow_fields.append(_arrow_field(name, kind, elem, zone and zone["timezone"]))
        header = bytearray()
        _put_struct(header, [(1, T_I32, DATA_PAGE), (2, T_I32, len(raw)), (3, T_I32, len(raw)),
                             (5, T_STRUCT, [(1, T_I32, count), (2, T_I32, PLAIN),
                                            (3, T_I32, RLE), (4, T_I32, RLE)])])
        offset = len(body)
        body += header + raw
        size = len(header) + len(raw)
        total += size
        chunks.append([(2, T_I64, offset), (3, T_STRUCT, [
            (1, T_I32, _PHYSICAL[leaf_kind]), (2, T_LIST, (T_I32, [PLAIN, RLE])),
            (3, T_LIST, (T_BINARY, path_in_schema)), (4, T_I32, 0), (5, T_I64, count),
            (6, T_I64, size), (7, T_I64, size), (9, T_I64, offset)])])
        frame_cols.append({"name": name, "field_name": name, "pandas_type": dtypes[0],
                            "numpy_type": dtypes[1], "metadata": zone})
    frame_meta = {
        "index_columns": [{"kind": "range", "name": None, "start": 0, "stop": n, "step": 1}],
        "column_indexes": [{"name": None, "field_name": None, "pandas_type": "unicode",
                            "numpy_type": "str", "metadata": {"encoding": "UTF-8"}}
                           if names else
                           {"name": None, "field_name": None, "pandas_type": "int64",
                            "numpy_type": "int64", "metadata": None}],
        "columns": frame_cols,
        "attributes": {},
        "creator": {"library": "instageo_tpu_torch", "version": "1"},
    }
    frame_json = json.dumps(frame_meta)
    footer = bytearray()
    _put_struct(footer, [
        (1, T_I32, 2),
        (2, T_LIST, (T_STRUCT, schema)),
        (3, T_I64, n),
        (4, T_LIST, (T_STRUCT, [[(1, T_LIST, (T_STRUCT, chunks)), (2, T_I64, total),
                                 (3, T_I64, n), (5, T_I64, 4), (6, T_I64, total),
                                 (7, T_I16, 0)]])),
        (5, T_LIST, (T_STRUCT, [[(1, T_BINARY, "pandas"), (2, T_BINARY, frame_json)],
                                [(1, T_BINARY, "ARROW:schema"),
                                 (2, T_BINARY, _arrow_schema(arrow_fields, frame_json))]])),
        (6, T_BINARY, "instageo_tpu_torch"),
    ])
    body += footer + struct.pack("<I", len(footer)) + MAGIC
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(bytes(body))
    os.replace(tmp, path)
