"""JPEG 2000 decoding through the system's OpenJPEG library (``libopenjp2``).

The JAX package decodes the Sentinel-2 JP2 band files of a CDSE granule with
``cv2.imread``, which goes through OpenJPEG; the card's machine has no
OpenCV, so the port binds ``libopenjp2`` itself with ``ctypes``, as it binds
its CUDA libraries. The library is loaded at the first decode; where it
cannot be loaded, ``read_jp2`` raises an ``OSError`` that names it.

``read_jp2`` returns a one-component image as ``cv2.imread(path,
cv2.IMREAD_UNCHANGED)`` does: (H, W), uint8 up to 8 bits of precision,
uint16 up to 16 (int8 / int16 where the component is signed).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Optional

import numpy as np

LIBRARY = "libopenjp2"
_JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
_J2K_SIGNATURE = b"\xff\x4f\xff\x51"
_CODEC_J2K, _CODEC_JP2 = 0, 2
_DPARAMETERS_BYTES = 1 << 16  # room for opj_dparameters_t, which the library fills


class _ImageComp(ctypes.Structure):
    """``opj_image_comp_t`` (OpenJPEG 2.x)."""
    _fields_ = [("dx", ctypes.c_uint32), ("dy", ctypes.c_uint32),
                ("w", ctypes.c_uint32), ("h", ctypes.c_uint32),
                ("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32),
                ("prec", ctypes.c_uint32), ("bpp", ctypes.c_uint32),
                ("sgnd", ctypes.c_uint32), ("resno_decoded", ctypes.c_uint32),
                ("factor", ctypes.c_uint32), ("data", ctypes.POINTER(ctypes.c_int32)),
                ("alpha", ctypes.c_uint16)]


class _Image(ctypes.Structure):
    """``opj_image_t`` (OpenJPEG 2.x)."""
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32),
                ("x1", ctypes.c_uint32), ("y1", ctypes.c_uint32),
                ("numcomps", ctypes.c_uint32), ("color_space", ctypes.c_int),
                ("comps", ctypes.POINTER(_ImageComp)),
                ("icc_profile_buf", ctypes.c_void_p), ("icc_profile_len", ctypes.c_uint32)]


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p = ctypes.c_void_p
    sigs = {
        "opj_stream_create_default_file_stream": ([ctypes.c_char_p, ctypes.c_int], p),
        "opj_create_decompress": ([ctypes.c_int], p),
        "opj_set_default_decoder_parameters": ([p], None),
        "opj_setup_decoder": ([p, p], ctypes.c_int),
        "opj_read_header": ([p, p, ctypes.POINTER(ctypes.POINTER(_Image))], ctypes.c_int),
        "opj_decode": ([p, p, ctypes.POINTER(_Image)], ctypes.c_int),
        "opj_end_decompress": ([p, p], ctypes.c_int),
        "opj_image_destroy": ([ctypes.POINTER(_Image)], None),
        "opj_stream_destroy": ([p], None),
        "opj_destroy_codec": ([p], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def library() -> ctypes.CDLL:
    """The loaded ``libopenjp2``; raises ``OSError`` naming it where it
    cannot be loaded."""
    global _lib
    with _lock:
        if _lib is None:
            errors = []
            for name in filter(None, (ctypes.util.find_library("openjp2"), "libopenjp2.so.7")):
                try:
                    _lib = _bind(ctypes.CDLL(name))
                    break
                except (OSError, AttributeError) as e:
                    errors.append(f"{name}: {e}")
            else:
                raise OSError(f"{LIBRARY} (OpenJPEG 2) could not be loaded, so JPEG 2000 "
                              f"files cannot be decoded: {'; '.join(errors) or 'not found'}")
        return _lib


def read_jp2(path: str) -> np.ndarray:
    """The one-component image of a JP2 file or J2K codestream at ``path``;
    raises ``IOError`` where it cannot be decoded."""
    lib = library()
    with open(path, "rb") as f:
        head = f.read(12)
    if head.startswith(_JP2_SIGNATURE):
        codec_format = _CODEC_JP2
    elif head.startswith(_J2K_SIGNATURE):
        codec_format = _CODEC_J2K
    else:
        raise IOError(f"Cannot decode JP2 {path}: not a JPEG 2000 file")
    stream = lib.opj_stream_create_default_file_stream(path.encode(), 1)
    codec = lib.opj_create_decompress(codec_format)
    image = ctypes.POINTER(_Image)()
    try:
        params = ctypes.create_string_buffer(_DPARAMETERS_BYTES)
        lib.opj_set_default_decoder_parameters(params)
        if not (stream and codec and lib.opj_setup_decoder(codec, params)
                and lib.opj_read_header(stream, codec, ctypes.byref(image))
                and lib.opj_decode(codec, stream, image)
                and lib.opj_end_decompress(codec, stream)):
            raise IOError(f"Cannot decode JP2 {path}")
        img = image.contents
        if img.numcomps != 1:
            raise IOError(f"{path}: {img.numcomps} components; a band file has one")
        comp = img.comps[0]
        values = np.ctypeslib.as_array(comp.data, shape=(comp.h, comp.w)).copy()
        if comp.prec <= 8:
            dtype = np.int8 if comp.sgnd else np.uint8
        elif comp.prec <= 16:
            dtype = np.int16 if comp.sgnd else np.uint16
        else:
            dtype = np.int32
        return values.astype(dtype)
    finally:
        if image:
            lib.opj_image_destroy(image)
        if codec:
            lib.opj_destroy_codec(codec)
        if stream:
            lib.opj_stream_destroy(stream)
