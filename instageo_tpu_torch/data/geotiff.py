"""Self-contained GeoTIFF codec for the serving path (no GDAL/rasterio).

The port's own copy of the reader and writer in
``instageo_tpu/data/geotiff.py`` (``Affine``, ``GeoTiffReader``,
``write_geotiff``, ``write_cog`` and their helpers):

* **Reader**: baseline TIFF, striped and tiled, chunky and planar,
  uint8/int8/uint16/int16/int32/uint32/float32/float64 samples, compressions
  none (1), LZW (5), deflate (8/32946), PackBits (32773), horizontal
  predictor (2), GeoTIFF georeferencing tags, GDAL nodata tag.
* **Writer**: striped or tiled chunky GeoTIFFs, deflate/LZW/none, GeoTIFF
  tags (pixel scale + tiepoint + EPSG geokeys), GDAL nodata; Cloud-Optimized
  GeoTIFFs (tiles plus a 2x overview pyramid, one IFD per level).

The surface mirrors the slice of rasterio the reference uses (``read()``
returning (bands, rows, cols), ``Affine``-style transforms).
"""

from __future__ import annotations

import math
import struct
import zlib
from dataclasses import dataclass
from typing import Any, BinaryIO, Dict, List, Optional, Sequence, Tuple

import numpy as np

# --- TIFF tag ids ----------------------------------------------------------
T_IMAGE_WIDTH = 256
T_IMAGE_LENGTH = 257
T_BITS_PER_SAMPLE = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_STRIP_OFFSETS = 273
T_SAMPLES_PER_PIXEL = 277
T_ROWS_PER_STRIP = 278
T_STRIP_BYTE_COUNTS = 279
T_PLANAR_CONFIG = 284
T_PREDICTOR = 317
T_TILE_WIDTH = 322
T_TILE_LENGTH = 323
T_TILE_OFFSETS = 324
T_TILE_BYTE_COUNTS = 325
T_SAMPLE_FORMAT = 339
T_MODEL_PIXEL_SCALE = 33550
T_MODEL_TIEPOINT = 33922
T_MODEL_TRANSFORM = 34264
T_GEO_KEY_DIRECTORY = 34735
T_GEO_DOUBLE_PARAMS = 34736
T_GEO_ASCII_PARAMS = 34737
T_GDAL_METADATA = 42112
T_GDAL_NODATA = 42113

# GeoKey ids
GK_MODEL_TYPE = 1024
GK_RASTER_TYPE = 1025
GK_GEOGRAPHIC_TYPE = 2048
GK_PROJECTED_CS_TYPE = 3072

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d",
             16: "Q", 17: "q"}


@dataclass(frozen=True)
class Affine:
    """2D affine transform (a, b, c, d, e, f): x = a·col + b·row + c, etc.

    Matches rasterio/GDAL's ``Affine(a, b, c, d, e, f)`` convention.
    """

    a: float
    b: float
    c: float
    d: float
    e: float
    f: float

    def __mul__(self, colrow: Tuple[float, float]) -> Tuple[float, float]:
        col, row = colrow
        return (self.a * col + self.b * row + self.c,
                self.d * col + self.e * row + self.f)

    def invert(self) -> "Affine":
        det = self.a * self.e - self.b * self.d
        if det == 0:
            raise ValueError("Non-invertible transform")
        ia, ib = self.e / det, -self.b / det
        id_, ie = -self.d / det, self.a / det
        ic = -(ia * self.c + ib * self.f)
        if_ = -(id_ * self.c + ie * self.f)
        return Affine(ia, ib, ic, id_, ie, if_)

    def rowcol(self, x: float, y: float) -> Tuple[int, int]:
        inv = self.invert()
        col, row = inv * (x, y)
        return int(math.floor(row)), int(math.floor(col))

    def xy(self, row: float, col: float, offset: str = "center") -> Tuple[float, float]:
        shift = 0.5 if offset == "center" else 0.0
        return self * (col + shift, row + shift)

    @staticmethod
    def from_origin(west: float, north: float, xsize: float, ysize: float) -> "Affine":
        return Affine(xsize, 0.0, west, 0.0, -ysize, north)

    def to_gdal(self) -> Tuple[float, ...]:
        return (self.c, self.a, self.b, self.f, self.d, self.e)


_DTYPE_TO_SF = {  # numpy kind -> TIFF SampleFormat
    "u": 1, "i": 2, "f": 3,
}
_SF_TO_KIND = {1: "u", 2: "i", 3: "f"}


def _np_dtype(bits: int, sample_format: int, endian: str) -> np.dtype:
    kind = _SF_TO_KIND.get(sample_format, "u")
    return np.dtype(f"{endian}{kind}{bits // 8}")


def _decode_lzw(data: bytes) -> bytes:
    """TIFF LZW decompressor (MSB-first codes, early-change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table: List[bytes] = []

    def reset():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset()
    code_bits = 9
    buf = 0
    nbits = 0
    prev: Optional[bytes] = None
    for byte in data:
        buf = (buf << 8) | byte
        nbits += 8
        while nbits >= code_bits:
            nbits -= code_bits
            code = (buf >> nbits) & ((1 << code_bits) - 1)
            if code == CLEAR:
                reset()
                code_bits = 9
                prev = None
                continue
            if code == EOI:
                return bytes(out)
            if prev is None:
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            else:
                entry = prev + prev[:1]
                table.append(entry)
            out += entry
            prev = entry
            # libtiff convention (validated against libtiff streams in
            # tests): widen when the next table index would not fit.
            if len(table) + 1 >= (1 << code_bits) and code_bits < 12:
                code_bits += 1
    return bytes(out)


def _encode_lzw(data: bytes) -> bytes:
    """TIFF LZW compressor (MSB-first, early-change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    buf = 0
    nbits = 0
    code_bits = 9

    def emit(code: int):
        nonlocal buf, nbits
        buf = (buf << code_bits) | code
        nbits += code_bits
        while nbits >= 8:
            nbits -= 8
            out.append((buf >> nbits) & 0xFF)

    table: Dict[bytes, int] = {bytes([i]): i for i in range(256)}
    next_code = 258
    emit(CLEAR)
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
        else:
            emit(table[w])
            table[wc] = next_code
            next_code += 1
            # Mirror of the decoder condition: widen once the decoder's
            # table (which lags ours by one) is about to need more bits.
            if next_code == (1 << code_bits) and code_bits < 12:
                code_bits += 1
            elif next_code >= 4094:
                # Reset before the 12-bit table fills (libtiff-safe).
                emit(CLEAR)
                table = {bytes([i]): i for i in range(256)}
                next_code = 258
                code_bits = 9
            w = bytes([byte])
    if w:
        emit(table[w])
    emit(EOI)
    if nbits:
        out.append((buf << (8 - nbits)) & 0xFF)
    return bytes(out)


def _decode_packbits(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and len(out) < expected:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i : i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i : i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _apply_predictor(arr: np.ndarray) -> np.ndarray:
    """Undo horizontal-difference predictor in place over the last axis."""
    np.cumsum(arr, axis=-1, dtype=arr.dtype, out=arr)
    return arr


class TiffIFD:
    """One image file directory: tag map + decode logic."""

    def __init__(self, fp: BinaryIO, offset: int, endian: str) -> None:
        self.fp = fp
        self.endian = endian
        fp.seek(offset)
        (count,) = struct.unpack(endian + "H", fp.read(2))
        raw = fp.read(count * 12)
        (self.next_ifd,) = struct.unpack(endian + "I", fp.read(4))
        self.tags: Dict[int, Any] = {}
        for i in range(count):
            tag, typ, cnt = struct.unpack_from(endian + "HHI", raw, i * 12)
            size = _TYPE_SIZES.get(typ, 1) * cnt
            if size <= 4:
                val_bytes = raw[i * 12 + 8 : i * 12 + 8 + size]
            else:
                (off,) = struct.unpack_from(endian + "I", raw, i * 12 + 8)
                here = fp.tell()
                fp.seek(off)
                val_bytes = fp.read(size)
                fp.seek(here)
            self.tags[tag] = self._parse(typ, cnt, val_bytes)

    def _parse(self, typ: int, cnt: int, b: bytes) -> Any:
        if typ == 2:  # ASCII
            return b.rstrip(b"\0").decode("latin-1", "replace")
        if typ in (5, 10):  # RATIONAL
            fmt = "I" if typ == 5 else "i"
            vals = struct.unpack(self.endian + fmt * (2 * cnt), b)
            out = [vals[2 * i] / (vals[2 * i + 1] or 1) for i in range(cnt)]
            return out[0] if cnt == 1 else out
        fmt = _TYPE_FMT.get(typ)
        if fmt is None:
            return b
        vals = struct.unpack(self.endian + fmt * cnt, b)
        return vals[0] if cnt == 1 else list(vals)

    def get(self, tag: int, default: Any = None) -> Any:
        return self.tags.get(tag, default)

    # -- decoding ---------------------------------------------------------

    @property
    def width(self) -> int:
        return int(self.get(T_IMAGE_WIDTH))

    @property
    def height(self) -> int:
        return int(self.get(T_IMAGE_LENGTH))

    @property
    def samples(self) -> int:
        return int(self.get(T_SAMPLES_PER_PIXEL, 1))

    @property
    def dtype(self) -> np.dtype:
        bits = self.get(T_BITS_PER_SAMPLE, 8)
        if isinstance(bits, list):
            bits = bits[0]
        sf = self.get(T_SAMPLE_FORMAT, 1)
        if isinstance(sf, list):
            sf = sf[0]
        return _np_dtype(int(bits), int(sf), self.endian)

    @property
    def is_tiled(self) -> bool:
        return T_TILE_OFFSETS in self.tags

    def _decompress(self, data: bytes, expected: int) -> bytes:
        comp = int(self.get(T_COMPRESSION, 1))
        if comp == 1:
            return data
        if comp in (8, 32946):
            return zlib.decompress(data)
        if comp == 5:
            return _decode_lzw(data)
        if comp == 32773:
            return _decode_packbits(data, expected)
        raise NotImplementedError(f"TIFF compression {comp} not supported")

    def _maybe_unpredict(self, arr: np.ndarray) -> np.ndarray:
        pred = int(self.get(T_PREDICTOR, 1))
        if pred == 2:
            return _apply_predictor(arr)
        if pred not in (1, 2):
            # e.g. 3 = floating-point predictor (GDAL's default for f32
            # rasters): decoding as if unpredicted returns silently
            # corrupt pixels — fail loudly like unsupported compression.
            raise NotImplementedError(f"TIFF predictor {pred} not supported")
        return arr

    def read(self) -> np.ndarray:
        """Decode the full IFD to (samples, height, width)."""
        pred = int(self.get(T_PREDICTOR, 1))
        if pred not in (1, 2):
            raise NotImplementedError(f"TIFF predictor {pred} not supported")
        h, w, s = self.height, self.width, self.samples
        dt = self.dtype
        planar = int(self.get(T_PLANAR_CONFIG, 1))
        if self.is_tiled:
            return self._read_tiled(h, w, s, dt, planar)
        return self._read_striped(h, w, s, dt, planar)

    def _read_striped(self, h, w, s, dt, planar) -> np.ndarray:
        offsets = self.get(T_STRIP_OFFSETS)
        counts = self.get(T_STRIP_BYTE_COUNTS)
        if not isinstance(offsets, list):
            offsets, counts = [offsets], [counts]
        rps = int(self.get(T_ROWS_PER_STRIP, h) or h)
        rps = min(rps, h)
        itemsize = dt.itemsize
        predict = int(self.get(T_PREDICTOR, 1)) == 2
        if planar == 1:
            out = np.empty((h, w, s), dt)
            strips_total = math.ceil(h / rps)
            for i in range(strips_total):
                r0 = i * rps
                nrows = min(rps, h - r0)
                expected = nrows * w * s * itemsize
                self.fp.seek(offsets[i])
                raw = self._decompress(self.fp.read(counts[i]), expected)
                block = np.frombuffer(raw[:expected], dt).reshape(nrows, w, s).copy()
                if predict:
                    # Horizontal differencing is per sample component across
                    # columns: cumsum over the width axis.
                    np.cumsum(block, axis=1, dtype=dt, out=block)
                out[r0 : r0 + nrows] = block
            return np.ascontiguousarray(out.transpose(2, 0, 1))
        # planar == 2: strips per band, band-major
        out = np.empty((s, h, w), dt)
        strips_per_band = math.ceil(h / rps)
        for b in range(s):
            for i in range(strips_per_band):
                idx = b * strips_per_band + i
                r0 = i * rps
                nrows = min(rps, h - r0)
                expected = nrows * w * itemsize
                self.fp.seek(offsets[idx])
                raw = self._decompress(self.fp.read(counts[idx]), expected)
                block = np.frombuffer(raw[:expected], dt).reshape(nrows, w).copy()
                out[b, r0 : r0 + nrows] = self._maybe_unpredict(block)
        return out

    def _read_tiled(self, h, w, s, dt, planar) -> np.ndarray:
        tw = int(self.get(T_TILE_WIDTH))
        th = int(self.get(T_TILE_LENGTH))
        offsets = self.get(T_TILE_OFFSETS)
        counts = self.get(T_TILE_BYTE_COUNTS)
        if not isinstance(offsets, list):
            offsets, counts = [offsets], [counts]
        tiles_x = math.ceil(w / tw)
        tiles_y = math.ceil(h / th)
        itemsize = dt.itemsize
        if planar == 1:
            out = np.empty((h, w, s), dt)
            for ty in range(tiles_y):
                for tx in range(tiles_x):
                    idx = ty * tiles_x + tx
                    expected = th * tw * s * itemsize
                    self.fp.seek(offsets[idx])
                    raw = self._decompress(self.fp.read(counts[idx]), expected)
                    tile = np.frombuffer(raw[:expected], dt).reshape(th, tw, s).copy()
                    if int(self.get(T_PREDICTOR, 1)) == 2:
                        np.cumsum(tile, axis=1, dtype=dt, out=tile)
                    y0, x0 = ty * th, tx * tw
                    out[y0 : min(y0 + th, h), x0 : min(x0 + tw, w)] = tile[
                        : min(th, h - y0), : min(tw, w - x0)]
            return np.ascontiguousarray(out.transpose(2, 0, 1))
        out = np.empty((s, h, w), dt)
        tiles_per_band = tiles_y * tiles_x
        for b in range(s):
            for ty in range(tiles_y):
                for tx in range(tiles_x):
                    idx = b * tiles_per_band + ty * tiles_x + tx
                    expected = th * tw * itemsize
                    self.fp.seek(offsets[idx])
                    raw = self._decompress(self.fp.read(counts[idx]), expected)
                    tile = np.frombuffer(raw[:expected], dt).reshape(th, tw).copy()
                    if int(self.get(T_PREDICTOR, 1)) == 2:
                        tile = _apply_predictor(tile)
                    y0, x0 = ty * th, tx * tw
                    out[b, y0 : min(y0 + th, h), x0 : min(x0 + tw, w)] = tile[
                        : min(th, h - y0), : min(tw, w - x0)]
        return out

    # -- geo metadata -------------------------------------------------------

    def transform(self) -> Optional[Affine]:
        scale = self.get(T_MODEL_PIXEL_SCALE)
        tie = self.get(T_MODEL_TIEPOINT)
        if scale and tie:
            sx, sy = float(scale[0]), float(scale[1])
            i, j, _, x, y, _ = [float(v) for v in tie[:6]]
            west = x - i * sx
            north = y + j * sy
            return Affine.from_origin(west, north, sx, sy)
        mt = self.get(T_MODEL_TRANSFORM)
        if mt:
            return Affine(float(mt[0]), float(mt[1]), float(mt[3]),
                          float(mt[4]), float(mt[5]), float(mt[7]))
        return None

    def crs_epsg(self) -> Optional[int]:
        gkd = self.get(T_GEO_KEY_DIRECTORY)
        if not gkd:
            return None
        n = gkd[3]
        keys = {}
        for i in range(n):
            kid, loc, cnt, val = gkd[4 + 4 * i : 8 + 4 * i]
            if loc == 0:
                keys[kid] = val
        if GK_PROJECTED_CS_TYPE in keys and keys[GK_PROJECTED_CS_TYPE] != 32767:
            return int(keys[GK_PROJECTED_CS_TYPE])
        if GK_GEOGRAPHIC_TYPE in keys and keys[GK_GEOGRAPHIC_TYPE] != 32767:
            return int(keys[GK_GEOGRAPHIC_TYPE])
        return None

    def nodata(self) -> Optional[float]:
        raw = self.get(T_GDAL_NODATA)
        if raw is None:
            return None
        try:
            return float(str(raw).strip())
        except ValueError:
            return None


class GeoTiffReader:
    """Random-access GeoTIFF reader with a rasterio-like surface."""

    def __init__(self, path, fp: Optional[BinaryIO] = None) -> None:
        """Open a GeoTIFF from a filesystem path or a seekable file object."""
        self.path = path if isinstance(path, str) else getattr(path, "url", "<fp>")
        if fp is not None:
            self.fp = fp
        elif isinstance(path, str):
            self.fp = open(path, "rb")
        else:
            self.fp = path
        head = self.fp.read(8)
        if head[:2] == b"II":
            self.endian = "<"
        elif head[:2] == b"MM":
            self.endian = ">"
        else:
            raise ValueError(f"{path}: not a TIFF")
        (magic,) = struct.unpack(self.endian + "H", head[2:4])
        if magic != 42:
            raise ValueError(f"{path}: unsupported TIFF magic {magic}")
        (off,) = struct.unpack(self.endian + "I", head[4:8])
        self.ifds = []
        seen = set()
        while off and off not in seen:
            seen.add(off)
            ifd = TiffIFD(self.fp, off, self.endian)
            self.ifds.append(ifd)
            off = ifd.next_ifd
        self.ifd = self.ifds[0]

    # rasterio-ish surface
    @property
    def width(self) -> int:
        return self.ifd.width

    @property
    def height(self) -> int:
        return self.ifd.height

    @property
    def count(self) -> int:
        return self.ifd.samples

    @property
    def dtypes(self) -> List[str]:
        base = self.ifd.dtype.newbyteorder("=")
        return [base.name] * self.count

    @property
    def transform(self) -> Optional[Affine]:
        return self.ifd.transform()

    @property
    def crs(self) -> Optional[int]:
        return self.ifd.crs_epsg()

    @property
    def nodata(self) -> Optional[float]:
        return self.ifd.nodata()

    @property
    def overviews(self) -> int:
        return len(self.ifds) - 1

    def read(self, indexes: Optional[Sequence[int]] = None,
             ifd_index: int = 0) -> np.ndarray:
        """Read bands (1-based indexes, rasterio convention)."""
        arr = self.ifds[ifd_index].read()
        arr = arr.astype(arr.dtype.newbyteorder("="), copy=False)
        if indexes is None:
            return arr
        if isinstance(indexes, int):
            return arr[indexes - 1]
        return arr[[i - 1 for i in indexes]]

    def close(self) -> None:
        self.fp.close()

    def __enter__(self) -> "GeoTiffReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _geokeys(epsg: Optional[int]) -> Optional[List[int]]:
    if epsg is None:
        return None
    if 4000 <= epsg < 5000:  # geographic
        model, key = 2, (GK_GEOGRAPHIC_TYPE, epsg)
    else:
        model, key = 1, (GK_PROJECTED_CS_TYPE, epsg)
    entries = [
        (GK_MODEL_TYPE, 0, 1, model),
        (GK_RASTER_TYPE, 0, 1, 1),  # PixelIsArea
        (key[0], 0, 1, key[1]),
    ]
    out = [1, 1, 0, len(entries)]
    for e in entries:
        out.extend(e)
    return out


def write_geotiff(
    path: str,
    array: np.ndarray,
    transform: Optional[Affine] = None,
    crs: Optional[int] = None,
    nodata: Optional[float] = None,
    compress: str = "deflate",
    tiled: bool = False,
    tile_size: int = 256,
    predictor: bool = False,
) -> None:
    """Write (bands, rows, cols) or (rows, cols) to a chunky GeoTIFF."""
    if array.ndim == 2:
        array = array[None]
    ifd, ext, blocks, _ = _serialize_ifd(
        array, transform, crs, nodata, tiled, tile_size, compress,
        base_offset=8, predictor=predictor)
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 8))
        f.write(ifd + struct.pack("<I", 0))  # next-IFD pointer: none
        f.write(ext)
        for b in blocks:
            f.write(b)
            if len(b) % 2:
                f.write(b"\0")


def _serialize_ifd(
    array: np.ndarray,
    transform: Optional[Affine],
    crs: Optional[int],
    nodata: Optional[float],
    tiled: bool,
    tile_size: int,
    compress: str,
    base_offset: int,
    predictor: bool = False,
    is_overview: bool = False,
) -> Tuple[bytes, bytes, List[bytes], int]:
    """Build one IFD's (entries+ext, blocks).

    Returns (ifd_bytes_without_next, ext_bytes, blocks, data_size). The
    caller appends the next-IFD pointer. ``base_offset`` is where this IFD
    starts in the file. An overview IFD is marked reduced-resolution and
    carries no georeferencing or nodata tags.
    """
    s, h, w = array.shape
    arr = np.ascontiguousarray(array.transpose(1, 2, 0))
    dt = arr.dtype
    if dt.byteorder == ">":
        arr = arr.astype(dt.newbyteorder("<"))
        dt = arr.dtype
    sf = _DTYPE_TO_SF.get(dt.kind)
    if sf is None:
        raise ValueError(f"Unsupported dtype {dt}")
    comp_id = {"none": 1, "deflate": 8, "lzw": 5}[compress]
    # Horizontal differencing (tag 317 = 2): integer dtypes only (the
    # float predictor 3 is a different, unimplemented scheme) and only
    # meaningful under compression. Mirrors the reader's cumsum-over-
    # width undo; wraparound integer subtraction is the TIFF convention.
    use_pred = bool(predictor) and comp_id != 1 and dt.kind in ("u", "i")

    def compress_block(block: np.ndarray) -> bytes:
        if use_pred:
            block = block.copy()
            block[:, 1:] = block[:, 1:] - block[:, :-1]
        raw = block.tobytes()
        if comp_id == 1:
            return raw
        if comp_id == 8:
            return zlib.compress(raw, 6)
        return _encode_lzw(raw)

    blocks: List[bytes] = []
    if tiled:
        th = tw = tile_size
        for ty in range(math.ceil(h / th)):
            for tx in range(math.ceil(w / tw)):
                tile = np.zeros((th, tw, s), dt)
                ys = min(th, h - ty * th)
                xs = min(tw, w - tx * tw)
                tile[:ys, :xs] = arr[ty * th : ty * th + ys,
                                     tx * tw : tx * tw + xs]
                blocks.append(compress_block(tile))
    else:
        rps = max(1, min(h, max(1, (1 << 16) // max(1, w * s * dt.itemsize))))
        for r0 in range(0, h, rps):
            blocks.append(compress_block(arr[r0 : r0 + rps]))

    tags: List[Tuple[int, int, List]] = [
        (T_IMAGE_WIDTH, 3, [w]),
        (T_IMAGE_LENGTH, 3, [h]),
        (T_BITS_PER_SAMPLE, 3, [dt.itemsize * 8] * s),
        (T_COMPRESSION, 3, [comp_id]),
        (T_PHOTOMETRIC, 3, [1]),
        (T_SAMPLES_PER_PIXEL, 3, [s]),
        (T_PLANAR_CONFIG, 3, [1]),
        (T_SAMPLE_FORMAT, 3, [sf] * s),
    ]
    if use_pred:
        tags.append((T_PREDICTOR, 3, [2]))
    if is_overview:
        tags.append((254, 4, [1]))  # NewSubfileType: reduced-resolution
    if tiled:
        tags += [
            (T_TILE_WIDTH, 3, [tile_size]),
            (T_TILE_LENGTH, 3, [tile_size]),
            (T_TILE_OFFSETS, 4, [0] * len(blocks)),
            (T_TILE_BYTE_COUNTS, 4, [len(b) for b in blocks]),
        ]
    else:
        rps = max(1, min(h, max(1, (1 << 16) // max(1, w * s * dt.itemsize))))
        tags += [
            (T_ROWS_PER_STRIP, 3, [rps]),
            (T_STRIP_OFFSETS, 4, [0] * len(blocks)),
            (T_STRIP_BYTE_COUNTS, 4, [len(b) for b in blocks]),
        ]
    if transform is not None and not is_overview:
        tags.append((T_MODEL_PIXEL_SCALE, 12, [transform.a, -transform.e, 0.0]))
        tags.append((T_MODEL_TIEPOINT, 12,
                     [0.0, 0.0, 0.0, transform.c, transform.f, 0.0]))
    gk = _geokeys(crs) if not is_overview else None
    if gk:
        tags.append((T_GEO_KEY_DIRECTORY, 3, gk))
    if nodata is not None and not is_overview:
        tags.append((T_GDAL_NODATA, 2, [f"{nodata:.10g}\0"]))
    tags.sort(key=lambda t: t[0])

    n_tags = len(tags)
    ifd_size = 2 + n_tags * 12 + 4
    ext_offset = base_offset + ifd_size

    def build(ext: bytearray, offsets: Optional[List[int]]) -> bytes:
        entries = b""
        for tag, typ, vals in tags:
            if offsets is not None and tag in (T_STRIP_OFFSETS, T_TILE_OFFSETS):
                vals = offsets
            if typ == 2:
                payload = vals[0].encode("latin-1")
                cnt = len(payload)
            else:
                fmt = _TYPE_FMT[typ]
                payload = struct.pack("<" + fmt * len(vals), *vals)
                cnt = len(vals)
            if len(payload) <= 4:
                entries += struct.pack("<HHI", tag, typ, cnt) + payload.ljust(4, b"\0")
            else:
                off = ext_offset + len(ext)
                ext += payload
                if len(ext) % 2:
                    ext += b"\0"
                entries += struct.pack("<HHII", tag, typ, cnt, off)
        return entries

    ext_probe = bytearray()
    build(ext_probe, None)
    data_offset = ext_offset + len(ext_probe)
    if data_offset % 2:
        data_offset += 1
    offsets = []
    pos = data_offset
    for b in blocks:
        offsets.append(pos)
        pos += len(b) + (len(b) % 2)
    ext = bytearray()
    entries = build(ext, offsets)
    ifd = struct.pack("<H", n_tags) + entries  # next-IFD appended by caller
    pad = data_offset - (ext_offset + len(ext))
    return ifd, bytes(ext) + b"\0" * pad, blocks, pos - base_offset


def write_cog(
    path: str,
    array: np.ndarray,
    transform: Optional[Affine] = None,
    crs: Optional[int] = None,
    nodata: Optional[float] = None,
    tile_size: int = 256,
    num_overviews: int = 6,
    compress: str = "deflate",
) -> None:
    """Write a Cloud-Optimized GeoTIFF: tiled + 2x overview pyramid.

    The reference's ``gdal_translate -of COG`` (cog_converter.py:125-174):
    deflate/LZW tiles, overview levels by nearest-neighbour decimation,
    halving until a level's short side is under ``max(2, tile_size // 4)``.
    """
    if array.ndim == 2:
        array = array[None]
    levels = [array]
    cur = array
    for _ in range(num_overviews):
        if min(cur.shape[1], cur.shape[2]) < max(2, tile_size // 4):
            break
        cur = cur[:, ::2, ::2]
        levels.append(cur)

    parts: List[Tuple[bytes, bytes, List[bytes], int]] = []
    offset = 8
    for i, lvl in enumerate(levels):
        ifd, ext, blocks, _ = _serialize_ifd(
            lvl, transform, crs, nodata, tiled=True, tile_size=tile_size,
            compress=compress, base_offset=offset, is_overview=i > 0)
        parts.append((ifd, ext, blocks, offset))
        offset += len(ifd) + 4 + len(ext) + sum(len(b) + (len(b) % 2) for b in blocks)

    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 8))
        for i, (ifd, ext, blocks, _) in enumerate(parts):
            next_off = parts[i + 1][3] if i + 1 < len(parts) else 0
            f.write(ifd + struct.pack("<I", next_off))
            f.write(ext)
            for b in blocks:
                f.write(b)
                if len(b) % 2:
                    f.write(b"\0")
