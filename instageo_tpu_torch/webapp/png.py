"""PNG encoder for RGBA images: ``zlib`` and ``struct``, no PIL.

What the tiler's tiles and previews and the map viewer's overlays need
(``Image.fromarray(rgba, "RGBA").save(buf, format="PNG")`` in the JAX
package): 8-bit RGBA, non-interlaced, every scanline with filter type 0,
one zlib stream in one IDAT chunk, a CRC-32 per chunk. The bytes differ
from PIL's (its filters and compression level); the decoded pixels are the
same.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_RGBA = 6


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgba: np.ndarray) -> bytes:
    """(height, width, 4) uint8 pixels as a PNG file's bytes."""
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4) uint8 RGBA, got {rgba.dtype} {rgba.shape}")
    h, w = rgba.shape[:2]
    rows = np.zeros((h, 1 + 4 * w), np.uint8)  # column 0: filter type 0 per row
    rows[:, 1:] = rgba.reshape(h, 4 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_RGBA, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
