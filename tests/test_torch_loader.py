"""The port's host path that feeds the card, against the JAX package's.

* The decoded-chip cache (``dataloader.cache_dir``): the port's
  counterparts of ``tests/data_tests/test_chip_cache.py``'s eight
  behaviours, with the cached arrays equal to the JAX package's
  ``get_raster_data`` / ``process_data`` on the same files.
* The native decoder (``instageo_tpu_torch.native``): bit for bit the JAX
  package's ``read_geotiff_native`` and both Python codecs, over dtypes ×
  {none, deflate, LZW} and a tiled COG; ``read_batch_native`` equals the
  per-file reads and zero-fills a corrupt file; the library lands under
  ``build/`` and concurrent builds agree.
* ``create_dataloader``'s worker modes: threads, spawned processes and no
  workers give the same batches; a worker's exception reaches the consumer;
  an abandoned epoch stops its producer.

Every comparison is exact (array_equal): the same decoders and the same
arithmetic on the same bytes.
"""

import csv
import os
import subprocess
import sys
import threading
import time
from functools import partial

import numpy as np
import pytest
import torch

from instageo_tpu import native as jax_native
from instageo_tpu.data import dataloader as jdl
from instageo_tpu.data.geotiff import Affine as JaxAffine
from instageo_tpu.data.geotiff import read_geotiff as jax_read_geotiff
from instageo_tpu.data.geotiff import write_cog as jax_write_cog
from instageo_tpu_torch import native
from instageo_tpu_torch.data import dataloader as pdl
from instageo_tpu_torch.data.geotiff import GeoTiffReader, write_geotiff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def chip(tmp_path):
    arr = np.random.default_rng(0).integers(1, 10000, size=(6, 32, 32)).astype(np.uint16)
    path = tmp_path / "chip_0.tif"
    write_geotiff(str(path), arr, compress="deflate", nodata=0)
    return str(path), arr


# ---------------------------------------------------------------------------
# The decoded-chip cache
# ---------------------------------------------------------------------------


def test_cache_roundtrip_bit_identical(chip, tmp_path):
    path, arr = chip
    cache = str(tmp_path / "cache")
    first = pdl._read_full_cached(path, cache)
    entries = os.listdir(cache)
    assert len(entries) == 1 and entries[0].endswith(".npy")
    second = pdl._read_full_cached(path, cache)
    for out in (first, second):
        np.testing.assert_array_equal(out, arr)
        assert out.dtype == arr.dtype
    np.testing.assert_array_equal(second, jdl._read_full_cached(path, str(tmp_path / "jax")))


def test_cache_hit_skips_decode(chip, tmp_path, monkeypatch):
    path, arr = chip
    cache = str(tmp_path / "cache")
    pdl._read_full_cached(path, cache)

    def boom(_):
        raise AssertionError("decode called on a warm cache")

    monkeypatch.setattr(pdl, "_read_full", boom)
    np.testing.assert_array_equal(pdl._read_full_cached(path, cache), arr)


def test_cache_invalidated_on_rewrite(chip, tmp_path):
    path, _ = chip
    cache = str(tmp_path / "cache")
    pdl._read_full_cached(path, cache)
    new = np.full((6, 32, 32), 7, np.uint16)
    write_geotiff(path, new, compress="deflate", nodata=0)
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    np.testing.assert_array_equal(pdl._read_full_cached(path, cache), new)
    assert len(os.listdir(cache)) == 1  # the older version's entry is pruned


def test_cache_keeps_a_newer_versions_entry(chip, tmp_path):
    """Pruning takes strictly older versions only: an entry a peer wrote
    for a newer mtime of the same source survives a write of an older one."""
    path, arr = chip
    cache = tmp_path / "cache"
    pdl._read_full_cached(path, str(cache))
    (entry,) = os.listdir(cache)
    h, mtime, size = entry[:-4].split("_")
    newer = cache / f"{h}_{int(mtime) + 10**9}_{size}.npy"
    os.replace(cache / entry, newer)
    np.testing.assert_array_equal(pdl._read_full_cached(path, str(cache)), arr)
    assert sorted(os.listdir(cache)) == sorted([entry, newer.name])


def test_corrupt_entry_self_heals(chip, tmp_path):
    path, arr = chip
    cache = str(tmp_path / "cache")
    pdl._read_full_cached(path, cache)
    entry = os.path.join(cache, os.listdir(cache)[0])
    with open(entry, "wb") as f:
        f.write(b"not an npy")
    np.testing.assert_array_equal(pdl._read_full_cached(path, cache), arr)
    np.testing.assert_array_equal(np.load(entry), arr)


def test_unwritable_cache_degrades_to_decode(chip, tmp_path):
    path, arr = chip
    blocked = tmp_path / "blocked"
    blocked.mkdir()
    blocked.chmod(0o500)
    try:
        np.testing.assert_array_equal(pdl._read_full_cached(path, str(blocked / "cache")), arr)
    finally:
        blocked.chmod(0o700)


def test_band_select_outside_cache_matches_jax(chip, tmp_path):
    path, arr = chip
    cache = str(tmp_path / "cache")
    out = pdl.get_raster_data(path, is_label=False, bands=[2, 0], cache_dir=cache)
    np.testing.assert_array_equal(out, arr[[2, 0]])
    np.testing.assert_array_equal(
        out, jdl.get_raster_data(path, is_label=False, bands=[2, 0], cache_dir=cache))
    entry = os.path.join(cache, os.listdir(cache)[0])
    assert np.load(entry).shape == arr.shape  # the entry is the full raster


def _write_rows(tmp_path, rows):
    with open(tmp_path / "t.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, ["Input", "Label"])
        writer.writeheader()
        writer.writerows(rows)
    return str(tmp_path / "t.csv")


def test_qa_scan_cached_matches_uncached_and_evicts(tmp_path):
    """The same rows with and without the cache, as the JAX scan keeps; the
    rows it drops (a label with no valid pixel under the chip's data, an
    unreadable chip) leave no entry behind."""
    rng = np.random.default_rng(2)
    lab = np.ones((1, 16, 16), np.int16)
    write_geotiff(str(tmp_path / "ok.tif"),
                  rng.integers(1, 10000, size=(6, 16, 16)).astype(np.uint16), nodata=0)
    write_geotiff(str(tmp_path / "ok_seg.tif"), lab, nodata=-1)
    write_geotiff(str(tmp_path / "bad.tif"), np.zeros((6, 16, 16), np.uint16), nodata=0)
    write_geotiff(str(tmp_path / "bad_seg.tif"), lab, nodata=-1)
    (tmp_path / "junk.tif").write_bytes(b"\x00" * 64)
    write_geotiff(str(tmp_path / "junk_seg.tif"), lab, nodata=-1)
    csv_path = _write_rows(tmp_path, [{"Input": f"{n}.tif", "Label": f"{n}_seg.tif"}
                                      for n in ("ok", "bad", "junk")])
    cache = str(tmp_path / "cache")
    plain = pdl.get_valid_filepaths(csv_path, str(tmp_path), no_data_value=0, ignore_index=-1)
    cached = pdl.get_valid_filepaths(csv_path, str(tmp_path), no_data_value=0,
                                     ignore_index=-1, cache_dir=cache)
    ref = jdl.get_valid_filepaths(csv_path, str(tmp_path), no_data_value=0, ignore_index=-1,
                                  cache_dir=str(tmp_path / "jax_cache"))
    assert plain == cached == ref
    assert [os.path.basename(p[0]) for p in plain] == ["ok.tif"]
    assert sorted(os.listdir(cache)) == sorted(os.listdir(tmp_path / "jax_cache"))
    assert len(os.listdir(cache)) == 2  # ok.tif and its label


def test_cached_process_data_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.integers(1, 10000, size=(6, 32, 32)).astype(np.uint16)
    lab = rng.integers(0, 3, size=(1, 32, 32)).astype(np.int16)
    im, mask = str(tmp_path / "chip.tif"), str(tmp_path / "seg.tif")
    write_geotiff(im, arr, compress="deflate", nodata=0)
    write_geotiff(mask, lab, compress="lzw", nodata=-1)
    kw = dict(reduce_to_zero=True, bands=[5, 1, 3], constant_multiplier=0.5,
              replace_label=(2, 7))
    for _ in range(2):  # cold, then warm
        ours = pdl.process_data(im, mask, cache_dir=str(tmp_path / "cache"), **kw)
        ref = jdl.process_data(im, mask, **kw)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The native decoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip(f"the native decoder does not build here: {native.unavailable_reason}")
    return native.lib_path()


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int16", "int32", "float32"])
@pytest.mark.parametrize("compress", ["none", "deflate", "lzw"])
def test_native_matches_jax_and_python_codecs(built, tmp_path, dtype, compress):
    rng = np.random.default_rng(0)
    if dtype.startswith("float"):
        arr = rng.normal(size=(5, 33, 47)).astype(dtype)
    else:
        arr = rng.integers(0, 200, size=(5, 33, 47)).astype(dtype)
    p = str(tmp_path / "x.tif")
    write_geotiff(p, arr, compress=compress)
    out = native.read_geotiff_native(p)
    with GeoTiffReader(p) as r:
        port_codec = r.read()
    for ref in (arr, port_codec, jax_read_geotiff(p)):
        np.testing.assert_array_equal(out, ref)
    if jax_native.available():
        np.testing.assert_array_equal(out, jax_native.read_geotiff_native(p))
    assert native.read_info(p) == (47, 33, 5, np.dtype(dtype))


def test_native_reads_tiled_cog(built, tmp_path):
    arr = np.random.default_rng(1).integers(0, 10000, size=(6, 200, 300)).astype(np.uint16)
    p = str(tmp_path / "cog.tif")
    jax_write_cog(p, arr, transform=JaxAffine.from_origin(0, 0, 30, 30), crs=32633,
                  tile_size=128)
    np.testing.assert_array_equal(native.read_geotiff_native(p), arr)
    with GeoTiffReader(p) as r:
        np.testing.assert_array_equal(r.read(), arr)


def test_native_batch_and_a_corrupt_file(built, tmp_path):
    rng = np.random.default_rng(2)
    paths, arrays = [], []
    for i in range(10):
        a = rng.integers(0, 10000, size=(6, 32, 32)).astype(np.uint16)
        paths.append(str(tmp_path / f"c{i}.tif"))
        write_geotiff(paths[-1], a, compress=("deflate", "lzw")[i % 2])
        arrays.append(a)
    before = native.decodes.count
    batch = native.read_batch_native(paths, (6, 32, 32), np.uint16, n_threads=4)
    np.testing.assert_array_equal(batch, np.stack([native.read_geotiff_native(p)
                                                   for p in paths]))
    np.testing.assert_array_equal(batch, np.stack(arrays))
    assert native.decodes.count - before == 20
    bad = str(tmp_path / "bad.tif")
    with open(bad, "wb") as f:
        f.write(b"garbage")
    mixed = native.read_batch_native([paths[0], bad, paths[1]], (6, 32, 32), np.uint16)
    np.testing.assert_array_equal(mixed[[0, 2]], np.stack(arrays[:2]))
    assert (mixed[1] == 0).all()
    with pytest.raises(IOError):
        native.read_geotiff_native(str(tmp_path / "missing.tif"))


def test_native_build_is_under_build_and_concurrent_builds_agree(built, tmp_path):
    """The library sits under build/instageo_tpu_torch/native/<hash>/; two
    fresh interpreters building into an empty ``INSTAGEO_COMPILE_CACHE_DIR`` at once both load
    a whole library, with the same bytes at the same path."""
    build_root = os.path.join(ROOT, "build", "instageo_tpu_torch", "native")
    assert str(built).startswith(build_root) and built.is_file()
    code = ("from instageo_tpu_torch import native\n"
            "assert native.available(), native.unavailable_reason\n"
            "print(native.lib_path())\n")
    env = dict(os.environ, INSTAGEO_COMPILE_CACHE_DIR=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    (path,) = paths
    assert path.startswith(str(tmp_path)) and os.path.isfile(path)
    assert not [f for f in os.listdir(os.path.dirname(path)) if f.startswith(".")]


def test_loader_reads_through_the_native_decoder(built, chip):
    path, arr = chip
    before = native.decodes.count
    np.testing.assert_array_equal(pdl.get_raster_data(path), arr)
    assert native.decodes.count == before + 1


# ---------------------------------------------------------------------------
# Worker modes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chip_csv(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(4)
    rows = []
    for i in range(7):
        write_geotiff(str(root / f"c{i}.tif"),
                      rng.integers(1, 10000, (6, 24, 24)).astype(np.uint16), nodata=0)
        write_geotiff(str(root / f"l{i}.tif"), rng.integers(0, 3, (1, 24, 24)).astype(np.int16))
        rows.append({"Input": f"c{i}.tif", "Label": f"l{i}.tif"})
    return _write_rows(root, rows), str(root)


AUGS = [{"name": "hflip", "p": 0.5}, {"name": "noise", "p": 0.5, "noise_std": 0.05}]


def _dataset(chip_csv, cache_dir=None):
    csv_path, root = chip_csv
    pre = partial(pdl.process_and_augment, mean=[5000.0] * 6, std=[3000.0] * 6,
                  im_size=16, augmentations=AUGS)
    return pdl.InstaGeoDataset(csv_path, root, pre, 0, -1, None, False, 1.0,
                               cache_dir=cache_dir, seed=11)


def _epochs(loader, n=2):
    return [[tuple(a.numpy() for a in batch) for batch in loader] for _ in range(n)]


def test_worker_modes_give_the_same_batches(chip_csv, tmp_path):
    """Threads, spawned processes and no workers: the same shuffled,
    augmented batches, epoch after epoch (draws seeded per (seed, epoch,
    index)); the cache changes nothing."""
    runs = {}
    for name, kw, cache in (("none", dict(num_workers=0), None),
                            ("thread", dict(num_workers=3, worker_mode="thread",
                                            prefetch_depth=1), None),
                            ("thread_cached", dict(num_workers=2), str(tmp_path / "c")),
                            ("process", dict(num_workers=2, worker_mode="process"), None)):
        loader = pdl.create_dataloader(_dataset(chip_csv, cache), 3, shuffle=True, seed=5, **kw)
        assert len(loader) == 3
        runs[name] = _epochs(loader)
        del loader
    ref = runs.pop("none")
    assert [len(e) for e in ref] == [3, 3] and ref[0][-1][0].shape[0] == 1
    assert not np.array_equal(ref[0][0][0], ref[1][0][0])
    for name, epochs in runs.items():
        for e_ref, e in zip(ref, epochs):
            for b_ref, b in zip(e_ref, e):
                for a_ref, a in zip(b_ref, b):
                    np.testing.assert_array_equal(a, a_ref, err_msg=name)
    with pytest.raises(ValueError, match="worker_mode"):
        pdl.create_dataloader(_dataset(chip_csv), 3, worker_mode="fork")


class _Failing(torch.utils.data.Dataset):
    def __len__(self):
        return 12

    def __getitem__(self, key):
        if key[1] == 7:
            raise KeyError("sample 7 is broken")
        return np.zeros((2, 4), np.float32), np.zeros((4,), np.int64)


def test_thread_worker_error_reaches_the_consumer():
    loader = pdl.create_dataloader(_Failing(), 2, num_workers=2)
    got = []
    with pytest.raises(KeyError, match="sample 7"):
        for batch in loader:
            got.append(batch)
    assert len(got) == 3  # the batches before the broken one arrive
    _wait_for_no_producer()


def _producers():
    return [t for t in threading.enumerate() if t.name == "instageo-loader"]


def _wait_for_no_producer(timeout=10.0):
    deadline = time.monotonic() + timeout
    while _producers() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _producers()


def test_breaking_out_of_an_epoch_stops_the_producer(chip_csv):
    loader = pdl.create_dataloader(_dataset(chip_csv), 1, num_workers=2, prefetch_depth=1)
    batches = iter(loader)
    next(batches)
    assert _producers()  # blocked on its full queue
    batches.close()
    _wait_for_no_producer()
    assert len(list(loader)) == 7  # the next epoch runs whole
    _wait_for_no_producer()



def test_dropping_a_process_epoch_early_ends_cleanly(built, tmp_path):
    """Four spawned workers with the native decoder over 32 chips of 18 bands
    (T=3) at 64 px: one batch of 4, then the epoch and the loader are
    dropped. Every worker must end cleanly: before the workers handed back
    numpy batches, each aborted at its interpreter's exit ("terminate called
    without an active exception") while its queue still moved tensors into
    shared memory."""
    rng = np.random.default_rng(8)
    rows = []
    for i in range(32):
        write_geotiff(str(tmp_path / f"c{i}.tif"),
                      rng.integers(1, 10000, (18, 64, 64)).astype(np.uint16))
        write_geotiff(str(tmp_path / f"l{i}.tif"),
                      rng.integers(0, 3, (1, 64, 64)).astype(np.int16))
        rows.append({"Input": f"c{i}.tif", "Label": f"l{i}.tif"})
    csv_path = _write_rows(tmp_path, rows)
    code = ("import sys\n"
            "from functools import partial\n"
            "from instageo_tpu_torch import native\n"
            "from instageo_tpu_torch.data import dataloader as pdl\n"
            "assert native.available(), native.unavailable_reason\n"
            "pre = partial(pdl.process_and_augment, mean=[0.0] * 6, std=[1.0] * 6,\n"
            "              temporal_size=3, im_size=64)\n"
            "ds = pdl.InstaGeoDataset(sys.argv[1], sys.argv[2], pre, 0, -1, None, False, 1.0)\n"
            "loader = pdl.create_dataloader(ds, 4, shuffle=True, num_workers=4,\n"
            "                               worker_mode='process')\n"
            "batches = iter(loader)\n"
            "x, y = next(batches)\n"
            "assert tuple(x.shape) == (4, 6, 3, 64, 64) and tuple(y.shape) == (4, 64, 64)\n"
            "del batches, loader\n")
    proc = subprocess.run([sys.executable, "-c", code, csv_path, str(tmp_path)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "terminate called" not in proc.stderr and "Aborted" not in proc.stderr, proc.stderr
