"""Coordinate reference systems: WGS84 <-> UTM and MGRS, in numpy.

The port's own copy of ``instageo_tpu/data/crs.py``, expression for
expression: the chips' positions depend on these floats, so the two
packages must give the same bits, not merely close values.

* transverse-Mercator projection via Karney's 6th-order Krüger series
  (sub-millimetre accuracy over UTM's domain);
* UTM zone logic with the Norway/Svalbard exceptions;
* MGRS encode/decode (grid-zone designator + 100 km square, any precision),
  matching the GeoTrans lettering scheme the ``mgrs`` package uses.

Vectorized over numpy arrays throughout.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np

# WGS84
_A = 6378137.0
_F = 1 / 298.257223563
_K0 = 0.9996
_E0 = 500000.0
_N0_SOUTH = 10000000.0

_n = _F / (2 - _F)
_n2, _n3, _n4, _n5, _n6 = _n**2, _n**3, _n**4, _n**5, _n**6
_AA = _A / (1 + _n) * (1 + _n2 / 4 + _n4 / 64 + _n6 / 256)

_ALPHA = np.array([
    _n / 2 - 2 * _n2 / 3 + 5 * _n3 / 16 + 41 * _n4 / 180 - 127 * _n5 / 288
    + 7891 * _n6 / 37800,
    13 * _n2 / 48 - 3 * _n3 / 5 + 557 * _n4 / 1440 + 281 * _n5 / 630
    - 1983433 * _n6 / 1935360,
    61 * _n3 / 240 - 103 * _n4 / 140 + 15061 * _n5 / 26880 + 167603 * _n6 / 181440,
    49561 * _n4 / 161280 - 179 * _n5 / 168 + 6601661 * _n6 / 7257600,
    34729 * _n5 / 80640 - 3418889 * _n6 / 1995840,
    212378941 * _n6 / 319334400,
])
_BETA = np.array([
    _n / 2 - 2 * _n2 / 3 + 37 * _n3 / 96 - _n4 / 360 - 81 * _n5 / 512
    + 96199 * _n6 / 604800,
    _n2 / 48 + _n3 / 15 - 437 * _n4 / 1440 + 46 * _n5 / 105
    - 1118711 * _n6 / 3870720,
    17 * _n3 / 480 - 37 * _n4 / 840 - 209 * _n5 / 4480 + 5569 * _n6 / 90720,
    4397 * _n4 / 161280 - 11 * _n5 / 504 - 830251 * _n6 / 7257600,
    4583 * _n5 / 161280 - 108847 * _n6 / 3991680,
    20648693 * _n6 / 638668800,
])
_DELTA = np.array([
    2 * _n - 2 * _n2 / 3 - 2 * _n3 + 116 * _n4 / 45 + 26 * _n5 / 45
    - 2854 * _n6 / 675,
    7 * _n2 / 3 - 8 * _n3 / 5 - 227 * _n4 / 45 + 2704 * _n5 / 315
    + 2323 * _n6 / 945,
    56 * _n3 / 15 - 136 * _n4 / 35 - 1262 * _n5 / 105 + 73814 * _n6 / 2835,
    4279 * _n4 / 630 - 332 * _n5 / 35 - 399572 * _n6 / 14175,
    4174 * _n5 / 315 - 144838 * _n6 / 6237,
    601676 * _n6 / 22275,
])

_E_SQRT = 2 * math.sqrt(_n) / (1 + _n)


def utm_zone(lat: float, lon: float) -> int:
    """UTM zone for a point, including Norway/Svalbard exceptions."""
    lon = ((lon + 180.0) % 360.0) - 180.0
    zone = int((lon + 180) // 6) + 1
    if 56 <= lat < 64 and 3 <= lon < 12:
        return 32
    if 72 <= lat < 84:
        if 0 <= lon < 9:
            return 31
        if 9 <= lon < 21:
            return 33
        if 21 <= lon < 33:
            return 35
        if 33 <= lon < 42:
            return 37
    return max(1, min(60, zone))


def utm_epsg(lat: float, lon: float) -> int:
    zone = utm_zone(lat, lon)
    return (32600 if lat >= 0 else 32700) + zone


def _tm_forward(lat_rad, lon_rad, lon0_rad):
    """Karney forward transverse Mercator -> (easting_raw, northing_raw)."""
    sphi = np.sin(lat_rad)
    t = np.sinh(np.arctanh(sphi) - _E_SQRT * np.arctanh(_E_SQRT * sphi))
    dlon = lon_rad - lon0_rad
    xi_p = np.arctan2(t, np.cos(dlon))
    eta_p = np.arctanh(np.sin(dlon) / np.sqrt(1 + t * t))
    xi = xi_p.copy()
    eta = eta_p.copy()
    for j in range(6):
        k = 2 * (j + 1)
        xi += _ALPHA[j] * np.sin(k * xi_p) * np.cosh(k * eta_p)
        eta += _ALPHA[j] * np.cos(k * xi_p) * np.sinh(k * eta_p)
    return _K0 * _AA * eta, _K0 * _AA * xi


def _tm_inverse(easting_raw, northing_raw, lon0_rad):
    xi = northing_raw / (_K0 * _AA)
    eta = easting_raw / (_K0 * _AA)
    xi_p = xi.copy()
    eta_p = eta.copy()
    for j in range(6):
        k = 2 * (j + 1)
        xi_p -= _BETA[j] * np.sin(k * xi) * np.cosh(k * eta)
        eta_p -= _BETA[j] * np.cos(k * xi) * np.sinh(k * eta)
    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))
    lat = chi.copy()
    for j in range(6):
        k = 2 * (j + 1)
        lat += _DELTA[j] * np.sin(k * chi)
    lon = lon0_rad + np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    return lat, lon


def latlon_to_utm(lat, lon, zone: int = None, south: bool = None):
    """(lat, lon) degrees -> (easting, northing, zone, south)."""
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    if zone is None:
        zone = utm_zone(float(np.atleast_1d(lat)[0]), float(np.atleast_1d(lon)[0]))
    if south is None:
        south = bool(np.atleast_1d(lat)[0] < 0)
    lon0 = math.radians(zone * 6 - 183)
    e_raw, n_raw = _tm_forward(np.radians(lat), np.radians(lon), lon0)
    easting = e_raw + _E0
    northing = n_raw + (_N0_SOUTH if south else 0.0)
    return easting, northing, zone, south


def utm_to_latlon(easting, northing, zone: int, south: bool = False):
    """(easting, northing, zone) -> (lat, lon) degrees."""
    easting = np.asarray(easting, np.float64)
    northing = np.asarray(northing, np.float64)
    lon0 = math.radians(zone * 6 - 183)
    n_raw = northing - (_N0_SOUTH if south else 0.0)
    lat, lon = _tm_inverse(easting - _E0, n_raw, lon0)
    return np.degrees(lat), np.degrees(lon)


class Transformer:
    """pyproj.Transformer-compatible subset for EPSG:4326 ↔ UTM codes."""

    def __init__(self, src_epsg: int, dst_epsg: int) -> None:
        self.src = src_epsg
        self.dst = dst_epsg

    @classmethod
    def from_crs(cls, src: Union[int, str], dst: Union[int, str],
                 always_xy: bool = True) -> "Transformer":
        def code(v):
            if isinstance(v, str):
                v = v.upper().replace("EPSG:", "")
            return int(v)

        return cls(code(src), code(dst))

    @staticmethod
    def _is_utm(epsg: int) -> bool:
        return 32601 <= epsg <= 32660 or 32701 <= epsg <= 32760

    def transform(self, x, y):
        """x/y in the axis order (lon, lat) for 4326 (always_xy)."""
        if self.src == self.dst:
            return np.asarray(x, np.float64), np.asarray(y, np.float64)
        if self.src == 4326 and self._is_utm(self.dst):
            zone = self.dst % 100
            south = self.dst // 100 == 327
            e, n, _, _ = latlon_to_utm(y, x, zone=zone, south=south)
            return e, n
        if self._is_utm(self.src) and self.dst == 4326:
            zone = self.src % 100
            south = self.src // 100 == 327
            lat, lon = utm_to_latlon(x, y, zone, south)
            return lon, lat
        if self._is_utm(self.src) and self._is_utm(self.dst):
            lon, lat = Transformer(self.src, 4326).transform(x, y)
            return Transformer(4326, self.dst).transform(lon, lat)
        raise NotImplementedError(
            f"Transform EPSG:{self.src} -> EPSG:{self.dst} not supported")


# ---------------------------------------------------------------------------
# MGRS
# ---------------------------------------------------------------------------

_BAND_LETTERS = "CDEFGHJKLMNPQRSTUVWX"  # 8° bands from -80 to +72 (X: 72-84)
_COL_SETS = ["ABCDEFGH", "JKLMNPQR", "STUVWXYZ"]  # indexed by (zone-1) % 3
_ROW_LETTERS = "ABCDEFGHJKLMNPQRSTUV"  # 20 letters


def _lat_band(lat: float) -> str:
    if lat >= 84 or lat < -80:
        raise ValueError(f"Latitude {lat} outside MGRS bands")
    if lat >= 72:
        return "X"
    return _BAND_LETTERS[int((lat + 80) // 8)]


def to_mgrs(lat: float, lon: float, precision: int = 0) -> str:
    """Encode a point to MGRS (precision 0 = '33TUN'-style 100 km square).

    Matches ``mgrs.MGRS().toMGRS(lat, lon, MGRSPrecision=p)``.
    """
    e, n, zone, south = latlon_to_utm(lat, lon)
    e = float(e)
    n = float(n)
    band = _lat_band(lat)
    col_idx = int(e // 100000)  # 1..8
    col_letter = _COL_SETS[(zone - 1) % 3][col_idx - 1]
    row_idx = int(n // 100000) % 20
    if zone % 2 == 0:  # even zones offset rows by 5 ('F')
        row_idx = (row_idx + 5) % 20
    row_letter = _ROW_LETTERS[row_idx]
    out = f"{zone:02d}{band}{col_letter}{row_letter}"
    if precision > 0:
        scale = 10 ** (5 - precision)
        ev = int((e % 100000) // scale)
        nv = int((n % 100000) // scale)
        out += f"{ev:0{precision}d}{nv:0{precision}d}"
    return out


def _band_center_northing(band: str) -> Tuple[float, bool]:
    """Approximate northing range start of a latitude band (for row disambig)."""
    idx = _BAND_LETTERS.index(band)
    lat_min = -80 + idx * 8
    south = lat_min < 0
    lat_mid = lat_min + (10 if band == "X" else 8) / 2
    _, n, _, _ = latlon_to_utm(lat_mid, 3.0)  # arbitrary lon; northing ~lat only
    return float(n), south


def mgrs_to_utm(code: str) -> Tuple[int, bool, float, float]:
    """Decode an MGRS code to (zone, south, easting, northing) of its SW corner
    at the coded precision."""
    code = code.strip().upper().replace(" ", "")
    zone = int(code[:2])
    band = code[2]
    col_letter, row_letter = code[3], code[4]
    digits = code[5:]
    precision = len(digits) // 2

    col_idx = _COL_SETS[(zone - 1) % 3].index(col_letter) + 1
    e100 = col_idx * 100000.0

    row_idx = _ROW_LETTERS.index(row_letter)
    if zone % 2 == 0:
        row_idx = (row_idx - 5) % 20
    band_n, south = _band_center_northing(band)
    # Find the northing whose 100km row matches row_idx, closest to band_n.
    base = row_idx * 100000.0
    candidates = base + np.arange(0, 10000000, 2000000.0)
    n100 = float(candidates[np.argmin(np.abs(candidates - band_n))])

    if precision:
        scale = 10 ** (5 - precision)
        e100 += int(digits[:precision]) * scale
        n100 += int(digits[precision:]) * scale
    return zone, south, e100, n100


def mgrs_to_latlon(code: str) -> Tuple[float, float]:
    """Decode an MGRS code to the lat/lon of its square's center."""
    code = code.strip().upper().replace(" ", "")
    digits = code[5:]
    precision = len(digits) // 2
    half = (10 ** (5 - precision)) / 2 if precision <= 5 else 0
    zone, south, e, n = mgrs_to_utm(code)
    lat, lon = utm_to_latlon(e + half, n + half, zone, south)
    return float(lat), float(lon)


def haversine_km(lat1, lon1, lat2, lon2) -> np.ndarray:
    """Great-circle distance in km (replaces the ``haversine`` package)."""
    lat1, lon1, lat2, lon2 = map(lambda v: np.radians(np.asarray(v, np.float64)),
                                 (lat1, lon1, lat2, lon2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = np.sin(dlat / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2) ** 2
    return 2 * 6371.0088 * np.arcsin(np.sqrt(a))
