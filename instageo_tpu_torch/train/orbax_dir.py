"""Orbax checkpoint directories without JAX: read and write.

The JAX package keeps a model as the directory that orbax's
``StandardCheckpointer`` writes. The port reads and writes that directory
itself, with numpy, ``json``, ``struct`` and ``ctypes``:

* ``read_tree(path)``: the nested tree of numpy arrays that
  ``ocp.StandardCheckpointer().restore(path)`` gives (dicts where a key is a
  name, lists where it is an index, None for an empty optimizer state, ``{}``
  for an empty dict, a Python number for a leaf saved as a scalar). The tree
  is rebuilt from ``_METADATA``'s ``key_metadata``; each array is a zarr v2
  array named by its keys joined with ``.``, read from one of two layouts:

  - **OCDBT** (``"use_ocdbt": true``, what orbax writes by default): a
    key-value store of one manifest (``manifest.ocdbt``, or the newest
    ``manifest.<generation>`` where the config says the manifests are
    numbered), a version tree and a B+tree of interior and leaf nodes,
    the nodes and the values held by reference in the data files under
    ``d/`` (and ``ocdbt.process_<i>/d/``). Every manifest and node carries a
    magic number, its length and a crc32c, all checked here; its body is
    uncompressed or zstd-compressed, as the config says.
  - **plain** (``"use_ocdbt": false``): one directory per array.

  Zarr v2 arrays: dtypes ``<f4``, ``<i4``, ``<f2``, any other numpy dtype
  orbax writes, and ``bfloat16`` (read as float32, which holds it exactly);
  scalars (``shape: []``); a grid of chunks with either
  ``dimension_separator``; ``fill_value`` where a chunk is absent; the
  ``zstd`` compressor or none.
* ``write_tree(path, tree, custom_metadata)``: the plain layout, which
  ``ocp.StandardCheckpointer().restore`` reads: ``_METADATA`` with
  ``"use_ocdbt": false``, ``_CHECKPOINT_METADATA`` (with
  ``custom_metadata``, which orbax keeps and ignores), and per array a
  ``.zarray`` and one uncompressed chunk. The directory is written beside
  ``path`` and renamed into place, replacing an older one.

zstd is decoded by the system's ``libzstd.so.1`` (``ZSTD_getFrameContentSize``,
``ZSTD_decompress``), loaded by ``ctypes`` at the first compressed block;
where it cannot be loaded, reading raises an ``OSError`` that names it.
Anything else this module cannot read raises ``OrbaxFormatError`` naming it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import itertools
import json
import math
import os
import shutil
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
MANIFEST = "manifest.ocdbt"
# What ``ocp.StandardCheckpointer`` records as the handler of its items.
ITEM_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                "StandardCheckpointHandler")

# OCDBT magic numbers (big-endian uint32 at the start of each encoded unit).
MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_NODE_MAGIC = 0x0CDB20DE
_MISSING = (1 << 64) - 1  # the offset and length of an empty tree's root
_KEY_INDEX, _KEY_NAME = 1, 2  # key_metadata key_type: sequence index, dict key


class OrbaxFormatError(ValueError):
    """A directory this module cannot read; the message names why."""


# --- zstd through the system library ----------------------------------------

ZSTD_LIBRARY = "libzstd.so.1"
_zstd_lock = threading.Lock()
_zstd: Optional[ctypes.CDLL] = None
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2


def zstd_library() -> ctypes.CDLL:
    """The loaded ``libzstd``; raises ``OSError`` naming it where it cannot
    be loaded."""
    global _zstd
    with _zstd_lock:
        if _zstd is None:
            errors = []
            for name in dict.fromkeys(filter(None, (ctypes.util.find_library("zstd"),
                                                    ZSTD_LIBRARY))):
                try:
                    lib = ctypes.CDLL(name)
                    size_t = ctypes.c_size_t
                    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, size_t]
                    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
                    lib.ZSTD_decompress.argtypes = [ctypes.c_char_p, size_t,
                                                    ctypes.c_char_p, size_t]
                    lib.ZSTD_decompress.restype = size_t
                    lib.ZSTD_isError.argtypes = [size_t]
                    lib.ZSTD_isError.restype = ctypes.c_uint
                    lib.ZSTD_getErrorName.argtypes = [size_t]
                    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
                    _zstd = lib
                    break
                except (OSError, AttributeError) as e:
                    errors.append(f"{name}: {e}")
            else:
                raise OSError(f"{ZSTD_LIBRARY} (zstd) could not be loaded, so the "
                              f"zstd-compressed parts of an orbax checkpoint cannot be "
                              f"read: {'; '.join(errors) or 'not found'}")
        return _zstd


def zstd_path() -> Optional[str]:
    """The file of the loaded ``libzstd`` as this process maps it (Linux),
    else None."""
    zstd_library()
    try:
        with open("/proc/self/maps") as f:
            for line in f:
                path = line.split()[-1]
                if "libzstd" in os.path.basename(path):
                    return path
    except OSError:
        pass
    return None


def zstd_decompress(data: bytes, size: Optional[int] = None) -> bytes:
    """One zstd frame, decoded. ``size`` is the decoded size where the frame
    does not record it (tensorstore's chunks do not); without either the
    buffer doubles until the frame fits."""
    lib = zstd_library()
    data = bytes(data)
    recorded = lib.ZSTD_getFrameContentSize(data, len(data))
    if recorded == _CONTENTSIZE_ERROR:
        raise OrbaxFormatError("not a zstd frame")
    if recorded != _CONTENTSIZE_UNKNOWN:
        size = recorded
    capacity = size if size is not None else max(4 * len(data), 1 << 16)
    while True:
        out = ctypes.create_string_buffer(max(capacity, 1))
        n = lib.ZSTD_decompress(out, capacity, data, len(data))
        if not lib.ZSTD_isError(n):
            if size is not None and n != size:
                raise OrbaxFormatError(f"zstd frame decoded to {n} bytes, expected {size}")
            return out.raw[:n]
        error = lib.ZSTD_getErrorName(n).decode()
        if size is not None or "too small" not in error or capacity > 1 << 34:
            raise OrbaxFormatError(f"zstd: {error}")
        capacity *= 2


# --- crc32c -----------------------------------------------------------------

def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the OCDBT format checks its units."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# --- OCDBT ------------------------------------------------------------------

class _Cursor:
    """Reads the format's little-endian fields and varints from ``buf``."""

    def __init__(self, buf: bytes, what: str) -> None:
        self.buf, self.pos, self.what = buf, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.buf):
            raise OrbaxFormatError(f"{self.what}: truncated")

    def varint(self) -> int:
        value = shift = 0
        while True:
            self._need(1)
            byte = self.buf[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise OrbaxFormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.buf[self.pos - 1]

    def raw(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def u64s(self, n: int) -> List[int]:
        return [struct.unpack("<Q", self.raw(8))[0] for _ in range(n)]

    def done(self) -> None:
        if self.pos != len(self.buf):
            raise OrbaxFormatError(f"{self.what}: {len(self.buf) - self.pos} bytes left over")


def _decode_unit(blob: bytes, magic: int, what: str) -> bytes:
    """The body of one encoded manifest or node: magic, length, format
    version 0, compression (0 none, 1 zstd), body, crc32c of all before it."""
    if len(blob) < 18:
        raise OrbaxFormatError(f"{what}: {len(blob)} bytes, too short")
    found, length = struct.unpack(">I", blob[:4])[0], struct.unpack("<Q", blob[4:12])[0]
    if found != magic:
        raise OrbaxFormatError(f"{what}: magic {found:#010x}, expected {magic:#010x}")
    if length != len(blob):
        raise OrbaxFormatError(f"{what}: says {length} bytes, has {len(blob)}")
    crc = struct.unpack("<I", blob[-4:])[0]
    if crc32c(blob[:-4]) != crc:
        raise OrbaxFormatError(f"{what}: crc32c mismatch")
    head = _Cursor(blob[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OrbaxFormatError(f"{what}: format version {version}")
    body = blob[12 + head.pos:-4]
    if compression == 1:
        return zstd_decompress(body)
    if compression != 0:
        raise OrbaxFormatError(f"{what}: compression format {compression}")
    return body


def _data_file_table(r: _Cursor) -> List[str]:
    """Data file paths, relative to the store's root: each path shares a
    prefix with the one before it; its first ``base_path_length`` bytes are
    the base path (e.g. ``ocdbt.process_0/``), the rest ``d/<name>``."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    paths: List[bytes] = []
    for i in range(n):
        paths.append((paths[-1][:prefix[i]] if i else b"") + r.raw(suffix[i]))
        if base[i] > len(paths[i]):
            raise OrbaxFormatError(f"{r.what}: base path longer than the path")
    return [p.decode() for p in paths]


def _file_ref(files: List[str], index: int, what: str) -> str:
    if index >= len(files):
        raise OrbaxFormatError(f"{what}: data file {index} of {len(files)}")
    return files[index]


def _versions(r: _Cursor, files: List[str]) -> List[dict]:
    """A column-wise list of versions (a manifest's inline versions or a
    leaf of the version tree)."""
    n = r.varint()
    gens = r.varints(n)
    heights = [r.u8() for _ in range(n)]
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    num_keys, tree_bytes, indirect_bytes = r.varints(n), r.varints(n), r.varints(n)
    times = r.u64s(n)
    return [dict(generation=gens[i], height=heights[i],
                 root=None if offsets[i] == _MISSING else
                 (_file_ref(files, ids[i], r.what), offsets[i], lengths[i]),
                 num_keys=num_keys[i], tree_bytes=tree_bytes[i],
                 indirect_bytes=indirect_bytes[i], commit_time=times[i])
            for i in range(n)]


def _version_refs(r: _Cursor, files: List[str], height: Optional[int]) -> List[dict]:
    """References to version tree nodes: a manifest's carry each node's
    height (last), an interior version node's children are one lower."""
    n = r.varint()
    gens, ids, offsets = r.varints(n), r.varints(n), r.varints(n)
    lengths, num_gens, times = r.varints(n), r.varints(n), r.u64s(n)
    heights = [r.u8() for _ in range(n)] if height is None else [height] * n
    return [dict(generation=gens[i], num_generations=num_gens[i], height=heights[i],
                 location=(_file_ref(files, ids[i], r.what), offsets[i], lengths[i]),
                 commit_time=times[i]) for i in range(n)]


class OcdbtStore:
    """One OCDBT store on the local file system: its newest manifest, its
    version tree and, for reads, the B+tree of its newest version."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        self._files: Dict[str, Any] = {}
        path = os.path.join(self.root, MANIFEST)
        manifest = self._manifest(path)
        if manifest["kind"] == 1:  # numbered: the newest manifest.<generation>
            numbered = [f for f in os.listdir(self.root)
                        if f.startswith("manifest.") and f != MANIFEST]
            if not numbered:
                raise OrbaxFormatError(f"{self.root}: numbered manifests, none found")
            newest = max(numbered, key=lambda f: int(f.split(".", 1)[1], 16))
            manifest = self._manifest(os.path.join(self.root, newest))
        self.config = manifest["config"]
        self.versions = manifest["versions"]
        self.version_nodes = manifest["version_nodes"]
        if not self.versions:
            raise OrbaxFormatError(f"{self.root}: the manifest holds no version")

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self) -> "OcdbtStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _read(self, rel: str, offset: int, length: int) -> bytes:
        f = self._files.get(rel)
        if f is None:
            path = os.path.join(self.root, rel)
            if not os.path.isfile(path):
                raise OrbaxFormatError(f"{self.root}: data file {rel} is missing")
            f = self._files[rel] = open(path, "rb")
        f.seek(offset)
        data = f.read(length)
        if len(data) != length:
            raise OrbaxFormatError(f"{self.root}/{rel}: {length} bytes at {offset} "
                                   f"past its end")
        return data

    def _manifest(self, path: str) -> dict:
        what = f"manifest {path}"
        if not os.path.isfile(path):
            raise OrbaxFormatError(f"{what}: missing")
        with open(path, "rb") as f:
            r = _Cursor(_decode_unit(f.read(), MANIFEST_MAGIC, what), what)
        uuid = r.raw(16)
        kind = r.varint()
        config = dict(uuid=uuid.hex(), manifest_kind=kind, max_inline_value_bytes=r.varint(),
                      max_decoded_node_bytes=r.varint(), version_tree_arity_log2=r.u8())
        method = r.varint()
        if method == 1:
            config["compression"] = {"id": "zstd", "level": struct.unpack("<i", r.raw(4))[0]}
        elif method == 0:
            config["compression"] = None
        else:
            raise OrbaxFormatError(f"{what}: compression method {method}")
        if kind == 1 and r.pos == len(r.buf):  # the config of numbered manifests
            return dict(kind=kind, config=config, versions=[], version_nodes=[])
        if kind not in (0, 1):
            raise OrbaxFormatError(f"{what}: manifest kind {kind}")
        files = _data_file_table(r)
        versions = _versions(r, files)
        nodes = _version_refs(r, files, None)
        r.done()
        return dict(kind=0, config=config, versions=versions, version_nodes=nodes)

    def generations(self) -> List[int]:
        """Every version's generation number, oldest first, from the
        version tree's nodes and the manifest's inline versions."""
        out: List[int] = []

        def walk(ref: dict) -> None:
            what = f"version node {ref['location']}"
            r = _Cursor(_decode_unit(self._read(*ref["location"]), VERSION_NODE_MAGIC, what),
                        what)
            arity_log2, height = r.u8(), r.u8()
            if arity_log2 != self.config["version_tree_arity_log2"] or height != ref["height"]:
                raise OrbaxFormatError(f"{what}: arity 2^{arity_log2} height {height}")
            files = _data_file_table(r)
            if height == 0:
                out.extend(v["generation"] for v in _versions(r, files))
            else:
                for child in _version_refs(r, files, height - 1):
                    walk(child)
            r.done()

        for ref in self.version_nodes:
            walk(ref)
        out.extend(v["generation"] for v in self.versions)
        return out

    def items(self, prefixes: Optional[Tuple[str, ...]] = None) -> Dict[str, bytes]:
        """Every key of the newest version with its value; only the keys
        that start with one of ``prefixes`` where given (the others' values
        held by reference are not read)."""
        out: Dict[str, bytes] = {}
        newest = self.versions[-1]
        if newest["root"] is not None:
            self._node(newest["root"], newest["height"], b"", out, prefixes)
        if prefixes is None and len(out) != newest["num_keys"]:
            raise OrbaxFormatError(f"{self.root}: {len(out)} keys, the manifest says "
                                   f"{newest['num_keys']}")
        return out

    def _node(self, location: Tuple[str, int, int], height: int, prefix: bytes,
              out: Dict[str, bytes], prefixes: Optional[Tuple[str, ...]]) -> None:
        what = f"{self.root} B+tree node {location}"
        r = _Cursor(_decode_unit(self._read(*location), BTREE_NODE_MAGIC, what), what)
        if r.u8() != height:
            raise OrbaxFormatError(f"{what}: not at height {height}")
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            raise OrbaxFormatError(f"{what}: no entries")
        shared = [0] + r.varints(n - 1)
        suffix = r.varints(n)
        subtree = r.varints(n) if height else None
        keys: List[bytes] = []
        for i in range(n):
            if i and shared[i] > len(keys[-1]):
                raise OrbaxFormatError(f"{what}: key prefix past the previous key")
            keys.append((keys[-1][:shared[i]] if i else b"") + r.raw(suffix[i]))
        if height:
            ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # num_keys, num_tree_bytes, num_indirect_value_bytes
            r.done()
            for i in range(n):
                child = (_file_ref(files, ids[i], what), offsets[i], lengths[i])
                self._node(child, height - 1, prefix + keys[i][:subtree[i]], out, prefixes)
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise OrbaxFormatError(f"{what}: value kind {max(kinds)}")
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        refs = dict(zip(indirect, zip(ids, offsets)))
        for i in range(n):
            key = (prefix + keys[i]).decode()
            value = None if i in refs else r.raw(lengths[i])
            if prefixes is not None and not key.startswith(prefixes):
                continue
            if i in refs:
                file_id, offset = refs[i]
                value = self._read(_file_ref(files, file_id, what), offset, lengths[i])
            out[key] = value
        r.done()


# --- zarr v2 ----------------------------------------------------------------

def _zarr_dtype(name: str) -> Tuple[np.dtype, bool]:
    """The dtype a chunk's bytes are read as, and whether it is bfloat16
    (read as uint16, given back as float32)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    try:
        return np.dtype(name), False
    except TypeError as e:
        raise OrbaxFormatError(f"zarr dtype {name!r}") from e


def _fill(value: Any) -> Any:
    if value is None:
        return 0
    if isinstance(value, str):
        return {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}[value]
    return value


def read_zarr(get: Callable[[str], Optional[bytes]], name: str) -> np.ndarray:
    """The zarr v2 array at ``name``; ``get(key)`` gives a stored value or
    None where there is none."""
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise OrbaxFormatError(f"{name}: no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise OrbaxFormatError(f"{name}: zarr_format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise OrbaxFormatError(f"{name}: zarr filters {meta['filters']}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: zarr compressor {compressor.get('id')!r}")
    order = meta.get("order", "C")
    if order not in ("C", "F"):
        raise OrbaxFormatError(f"{name}: zarr order {order!r}")
    dtype, bf16 = _zarr_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks):
        raise OrbaxFormatError(f"{name}: shape {shape} and chunks {chunks}")
    sep = meta.get("dimension_separator", ".")
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    if shape == chunks and compressor is None and not bf16 and dtype.isnative:
        # One uncompressed chunk (what ``write_tree`` writes): the array
        # is the chunk's buffer, without a copy.
        data = get(f"{name}/{sep.join('0' for _ in shape) or '0'}")
        if data is not None and len(data) == chunk_bytes:
            block = np.frombuffer(data, dtype).reshape(chunks, order=order)
            return block if block.flags.writeable else block.copy()
    out = np.full(shape, _fill(meta.get("fill_value")),
                  np.float32 if bf16 else dtype.newbyteorder("="))
    grid = [range(-(-s // c)) if c else range(0) for s, c in zip(shape, chunks)]
    for index in itertools.product(*grid):
        data = get(f"{name}/{sep.join(map(str, index)) if index else '0'}")
        if data is None:
            continue
        if compressor is not None:
            data = zstd_decompress(data, chunk_bytes)
        if len(data) != chunk_bytes:
            raise OrbaxFormatError(f"{name}: chunk {index} holds {len(data)} bytes, "
                                   f"expected {chunk_bytes}")
        block = np.frombuffer(data, dtype).reshape(chunks, order=order)
        if bf16:
            block = (block.astype("<u4") << 16).view("<f4")
        sel = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
    return out


# --- trees ------------------------------------------------------------------

def _store_reader(path: str, use_ocdbt: bool, prefixes: Optional[Tuple[str, ...]]):
    """``get(key)`` over the checkpoint's stored values: its OCDBT store's
    newest version (the keys under ``prefixes`` where given), or the plain
    layout's files."""
    if use_ocdbt:
        with OcdbtStore(path) as store:
            items = store.items(prefixes)
        return items.get

    def get(key: str) -> Optional[bytearray]:
        full = os.path.join(path, *key.split("/"))
        if not os.path.isfile(full):
            return None
        data = bytearray(os.path.getsize(full))  # writable: arrays view it as it is
        with open(full, "rb") as f:
            if f.readinto(data) != len(data):
                raise OrbaxFormatError(f"{full}: short read")
        return data

    return get


def read_tree(path: str, select: Optional[Tuple[str, ...]] = None) -> Dict[str, Any]:
    """The tree of an orbax checkpoint directory (either layout), as
    ``ocp.StandardCheckpointer().restore(path)`` gives it; only its
    top-level keys in ``select`` where given (the others are not read)."""
    md_path = os.path.join(path, METADATA)
    if not os.path.isfile(md_path):
        raise OrbaxFormatError(f"{path}: no {METADATA}; not an orbax checkpoint directory")
    with open(md_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise OrbaxFormatError(f"{path}: zarr v3 arrays (use_zarr3) are not read here")
    use_ocdbt = bool(meta.get("use_ocdbt", os.path.isfile(os.path.join(path, MANIFEST))))
    entries = [e for e in meta["tree_metadata"].values()
               if select is None or e["key_metadata"][0]["key"] in select]
    prefixes = None if select is None else tuple(p for k in select for p in (f"{k}.", f"{k}/"))
    get = _store_reader(path, use_ocdbt, prefixes)
    root: Dict[Any, Any] = {}
    for entry in entries:
        keys = entry["key_metadata"]
        value_meta = entry["value_metadata"]
        node = root
        for i, key in enumerate(keys):
            name = int(key["key"]) if key["key_type"] == _KEY_INDEX else key["key"]
            if i == len(keys) - 1:
                node[name] = _leaf(get, keys, value_meta)
            else:
                node = node.setdefault(name, {})
    return _lists(root, entries)


def _leaf(get, keys: List[dict], value_meta: dict) -> Any:
    kind = value_meta.get("value_type")
    if value_meta.get("skip_deserialize"):
        empty = {"None": None, "Dict": {}, "List": []}
        if kind not in empty:
            raise OrbaxFormatError(f"{keys}: leaf of type {kind!r}")
        return empty[kind]
    if kind not in ("np.ndarray", "jax.Array", "scalar"):
        raise OrbaxFormatError(f"{keys}: leaf of type {kind!r}")
    array = read_zarr(get, ".".join(str(k["key"]) for k in keys))
    return array.item() if kind == "scalar" else array


def _lists(root: Dict, entries: List[dict]) -> Dict:
    """Containers whose keys are sequence indices become lists."""
    indexed = set()
    for entry in entries:
        keys = entry["key_metadata"]
        for depth, key in enumerate(keys):
            if key["key_type"] == _KEY_INDEX:
                indexed.add(tuple(k["key"] for k in keys[:depth]))

    def convert(node, path):
        if not isinstance(node, dict):
            return node
        out = {k: convert(v, path + (str(k),)) for k, v in node.items()}
        if path in indexed:
            if sorted(out) != list(range(len(out))):
                raise OrbaxFormatError(f"{path}: sequence indices {sorted(out)}")
            return [out[i] for i in range(len(out))]
        return out

    return convert(root, ())


def _flatten(tree: Any, keys: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(key path, leaf) pairs; a key is (name, key_type)."""
    if isinstance(tree, dict) and tree:
        return [pair for k, v in tree.items()
                for pair in _flatten(v, keys + ((str(k), _KEY_NAME),))]
    if isinstance(tree, (list, tuple)) and tree:
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, keys + ((str(i), _KEY_INDEX),))]
    return [(keys, tree)]


def _zarr_name(dtype: np.dtype) -> str:
    if dtype.kind not in "biuf" or dtype.itemsize > 8:
        raise ValueError(f"dtype {dtype} is not written here")
    return dtype.newbyteorder("<").str if dtype.itemsize > 1 else dtype.str


def write_tree(path: str, tree: Dict[str, Any],
               custom_metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` (nested dicts and lists of arrays, numbers, None and
    empty dicts) as an orbax checkpoint directory in the plain layout,
    replacing ``path``; returns ``path``."""
    path = os.path.abspath(path)
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f"{name}.orbax-checkpoint-tmp-{os.getpid()}-{time.time_ns()}")
    started = time.time_ns()
    os.makedirs(tmp)
    try:
        tree_metadata = {}
        for keys, leaf in _flatten(tree):
            if not keys:
                raise ValueError("the tree's root must be a non-empty dict")
            key_metadata = [{"key": k, "key_type": t} for k, t in keys]
            if leaf is None or (isinstance(leaf, dict) and not leaf):
                value = {"value_type": "None" if leaf is None else "Dict",
                         "skip_deserialize": True}
            else:
                _write_zarr(os.path.join(tmp, ".".join(k for k, _ in keys)), leaf)
                value = {"value_type": "np.ndarray", "skip_deserialize": False}
            tree_metadata[str(tuple(k for k, _ in keys))] = {
                "key_metadata": key_metadata, "value_metadata": value}
        with open(os.path.join(tmp, METADATA), "w") as f:
            json.dump({"tree_metadata": tree_metadata, "use_ocdbt": False, "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
            json.dump({"item_handlers": ITEM_HANDLER, "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": dict(custom_metadata or {})}, f)
        old = None
        if os.path.lexists(path):
            old = f"{tmp}.old"
            os.rename(path, old)
        try:
            os.rename(tmp, path)
        except BaseException:
            if old is not None:  # the older checkpoint back in place
                os.rename(old, path)
            raise
        if old is not None:
            shutil.rmtree(old)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def _write_zarr(directory: str, leaf: Any) -> None:
    array = np.asarray(leaf)
    dtype = _zarr_name(array.dtype)
    os.makedirs(directory)
    shape = list(array.shape)
    meta = {"chunks": [max(s, 1) for s in shape], "compressor": None,
            "dimension_separator": ".", "dtype": dtype, "fill_value": None,
            "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
    with open(os.path.join(directory, ".zarray"), "w") as f:
        json.dump(meta, f)
    if array.size:
        chunk = ".".join("0" for _ in shape) or "0"
        with open(os.path.join(directory, chunk), "wb") as f:
            f.write(np.ascontiguousarray(array, dtype=np.dtype(dtype)).data)


def checkpoint_custom_metadata(path: str) -> Dict[str, Any]:
    """``_CHECKPOINT_METADATA``'s ``custom_metadata`` ({} where absent)."""
    try:
        with open(os.path.join(path, CHECKPOINT_METADATA)) as f:
            return dict(json.load(f).get("custom_metadata") or {})
    except FileNotFoundError:
        return {}
