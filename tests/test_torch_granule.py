"""Whole-granule inference of the port against the JAX package.

The tiny model (``prithvi_eo_tiny``, depth 2, 32 px, float32) with the same
seeded weights on both sides (``seg_state_dict_from_jax``), on the CPU.

* ``granule_inference``: classes equal wherever the JAX logits' top-2 gap
  is at least 1e-3 (float32 summation order may flip the argmax below it;
  more than 90% of pixels are decided), the −1 nodata pixels equal exactly;
  regression within 1e-4 absolute, NaN on the same pixels;
* stitching: the canvas equals the port's per-batch fused predict, stitched
  in chip order, bit for bit;
* the openers (HLS with L30 and S30 granules, S2, S1, ``open_stac_items``
  with nesting and non-nesting planes) on local GeoTIFFs, and ``HttpFile``
  through a fake session: arrays, transforms and CRSs equal;
* ``mode=sliding_inference device=cpu`` from a dataset JSON with local
  hrefs against JAX ``granule_inference_to_file`` with the same weights,
  from a checkpoint the port wrote and from one the JAX package wrote.

Asset loads are rate limited per process at import (30 a minute by
default); this module loads more than that, so it raises the port's limit
through ``INSTAGEO_COG_RATELIMIT`` before the loaders are imported, and
the JAX openers it compares with load without their limit.
"""

import json
import os
import types

os.environ.setdefault("INSTAGEO_COG_RATELIMIT", "1000")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from instageo_tpu.data import remote_io as jax_remote_io  # noqa: E402
from instageo_tpu.data import stac as jax_stac  # noqa: E402
from instageo_tpu.data.geotiff import GeoTiffReader as JaxGeoTiffReader  # noqa: E402
from instageo_tpu.data.sources import hls as jax_hls  # noqa: E402
from instageo_tpu.data.sources import s1 as jax_s1  # noqa: E402
from instageo_tpu.data.sources import s2 as jax_s2  # noqa: E402
from instageo_tpu.models.seg import create_prithvi_seg as jax_create_prithvi_seg  # noqa: E402
from instageo_tpu.ops.preprocess import preprocess_chips as jax_preprocess_chips  # noqa: E402
from instageo_tpu.serve import granule as jax_granule  # noqa: E402
from instageo_tpu.train.checkpointing import BestCheckpointer as JaxBestCheckpointer  # noqa: E402
from instageo_tpu_torch.data import remote_io, stac  # noqa: E402
from instageo_tpu_torch.data.geotiff import Affine, GeoTiffReader, write_geotiff  # noqa: E402
from instageo_tpu_torch.data.sources import hls, s1, s2  # noqa: E402
from instageo_tpu_torch.models.checkpoint import seg_state_dict_from_jax  # noqa: E402
from instageo_tpu_torch.models.registry import get_arch  # noqa: E402
from instageo_tpu_torch.models.seg import create_prithvi_seg  # noqa: E402
from instageo_tpu_torch.ops.preprocess import make_fused_predict_fn  # noqa: E402
from instageo_tpu_torch.serve import granule  # noqa: E402
from instageo_tpu_torch.train import run  # noqa: E402
from instageo_tpu_torch.train.checkpointing import BestCheckpointer  # noqa: E402
from tests.data_tests.test_remote_io import FakeSession  # noqa: E402
from tests.torch_parity import random_seg_variables  # noqa: E402

torch.set_num_threads(1)

GAP = 1e-3         # top-2 gap of the JAX logits above which classes must agree
DECIDED = 0.9      # share of pixels that must be decided
REG_ATOL = 1e-4    # regression outputs, float32 logits of two frameworks
KW = dict(depth=2, image_size=32, num_bands=6)
MEAN, STD = [5000.0] * 6, [3000.0] * 6


def _models(num_classes):
    jax_model = jax_create_prithvi_seg("prithvi_eo_tiny", temporal_step=1,
                                       num_classes=num_classes, **KW)
    variables = random_seg_variables(jax_model, 1, 32, seed=21)
    port = create_prithvi_seg("prithvi_eo_tiny", temporal_step=1, num_classes=num_classes,
                              device="cpu", **KW)
    arch = get_arch("prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32, depth=2)
    port.load_state_dict(seg_state_dict_from_jax(variables, arch), strict=True)
    return jax_model, variables, port


@pytest.fixture(scope="module")
def models():
    return _models(3)


@pytest.fixture(autouse=True)
def _jax_loads_unthrottled(monkeypatch):
    """The JAX package's loader read its limit when it was first imported,
    perhaps before this module raised it; the JAX openers that serve as
    references here load without the limit."""
    monkeypatch.setattr(jax_stac, "_load_asset", jax_stac._load_asset.__wrapped__)


def _jax_gap_canvas(tile, jax_model, variables, overlap=0, bands=None):
    """The JAX logits' top-2 gap per pixel, stitched as the granule is."""
    coords, bounds = granule.chip_grid(*tile.shape[1:], 32, overlap)
    gap = np.zeros(tile.shape[1:], np.float32)
    for (cx, cy), (y0, y1, x0, x1) in zip(coords, bounds):
        x = jax_preprocess_chips(jnp.asarray(tile[None, :, cy:cy + 32, cx:cx + 32]),
                                 jnp.asarray(MEAN), jnp.asarray(STD),
                                 bands=None if bands is None else tuple(bands))
        logits = np.asarray(jax_model.apply(variables, x, channels_last=True))[0]
        top2 = np.sort(logits, axis=-1)[..., -2:]
        gap[cy + y0:cy + y1, cx + x0:cx + x1] = (top2[..., 1] - top2[..., 0])[y0:y1, x0:x1]
    return gap


def _assert_classes_agree(ours, ref, gap):
    assert ours.dtype == ref.dtype == np.int8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours == -1, ref == -1)
    decided = (gap >= GAP) & (ref != -1)
    assert decided.mean() > DECIDED * (ref != -1).mean()
    np.testing.assert_array_equal(ours[decided], ref[decided])


@pytest.mark.parametrize("shape,batch,overlap", [((96, 128), 4, 0), ((80, 100), 5, 0),
                                                 ((96, 96), 8, 4)])
def test_granule_inference_matches_jax(models, shape, batch, overlap):
    """A whole grid, a tile with remainders (the last row and column
    clamped), and overlapped chips; a nodata block on every band."""
    jax_model, variables, port = models
    tile = np.random.default_rng(0).integers(1, 10000, size=(6, *shape)).astype(np.uint16)
    tile[:, 40:52, 10:30] = 0
    ref, _ = jax_granule.granule_inference(tile, jax_model, variables, MEAN, STD,
                                           chip_size=32, batch_size=batch, overlap=overlap)
    stats = {}
    ours, _ = granule.granule_inference(tile, port, MEAN, STD, chip_size=32,
                                        batch_size=batch, overlap=overlap, stats=stats)
    _assert_classes_agree(ours, np.asarray(ref), _jax_gap_canvas(tile, jax_model, variables,
                                                                  overlap))
    assert (ours[40:52, 10:30] == -1).all() and (ours[:40] >= 0).all()
    coords, _ = granule.chip_grid(*shape, 32, overlap)
    assert stats["chips"] == len(coords) and stats["batches"] == -(-len(coords) // batch)
    assert stats["device_s"] is None  # not measured on the CPU


def test_chip_grid_bounds_and_overlap_error():
    coords, bounds = granule.chip_grid(80, 100, 32, 4)
    # Stride 24: starts 0, 24, 48 and the clamped last one.
    assert sorted(set(coords[:, 0])) == [0, 24, 48, 68]
    assert sorted(set(coords[:, 1])) == [0, 24, 48]
    first = {(0, 0): (0, 28, 0, 28), (24, 24): (4, 28, 4, 28), (68, 48): (4, 32, 4, 32),
             (68, 0): (0, 28, 4, 32)}
    got = {(int(x), int(y)): tuple(int(v) for v in b) for (x, y), b in zip(coords, bounds)}
    assert {k: got[k] for k in first} == first
    for overlap in (16, 20, -1):
        with pytest.raises(ValueError, match="overlap"):
            granule.chip_grid(80, 100, 32, overlap)
    with pytest.raises(ValueError, match="smaller than chip_size"):
        granule.chip_grid(20, 100, 32)


def _padded_batch(tile, coords, b0, batch, chip=32):
    """The chips of one batch as the granule path forms it: the last batch
    padded to ``batch`` with copies of the chip at (0, 0)."""
    ids = list(coords[b0:b0 + batch]) + [(0, 0)] * max(0, b0 + batch - len(coords))
    return np.stack([tile[:, y:y + chip, x:x + chip] for x, y in ids])


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_stitching_matches_per_batch_fused_predict(models, batch):
    """The canvas is the port's fused predict on each batch of chips, the
    last batch padded as the granule path pads it, pasted in chip order
    (later chips win at the clamped edges), bit for bit."""
    _, _, port = models
    tile = np.random.default_rng(1).integers(1, 10000, size=(6, 80, 100)).astype(np.uint16)
    ours, _ = granule.granule_inference(tile, port, MEAN, STD, chip_size=32, batch_size=batch)
    predict = make_fused_predict_fn(port, MEAN, STD)
    coords, bounds = granule.chip_grid(80, 100, 32)
    expected = np.zeros((80, 100), np.int8)
    for b0 in range(0, len(coords), batch):
        preds = predict(_padded_batch(tile, coords, b0, batch)).numpy()
        for j, (x, y) in enumerate(coords[b0:b0 + batch]):
            expected[y:y + 32, x:x + 32] = preds[j]
    np.testing.assert_array_equal(ours, expected)


@pytest.mark.parametrize("batch", [5, 12, 16])
def test_granule_pads_the_last_batch(models, batch):
    """Every forward sees ``batch_size`` chips, as in the JAX package; the
    padding chips (copies of the chip at (0, 0)) write nothing: a model
    that marks its padding rows leaves no mark on the canvas, which equals
    the unpadded run within 1e-5 (float32, other batch shapes)."""
    _, _, port = models
    seen = []

    class Marked(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = port

        def forward(self, x, channels_last=True):
            first = len(seen) * batch  # the index of this batch's first chip
            seen.append(x.shape[0])
            out = self.inner(x, channels_last=True).float()
            out[max(0, n - first):] = -1e4  # the padding rows
            return out

    tile = np.random.default_rng(2).integers(1, 10000, size=(6, 80, 100)).astype(np.uint16)
    n = len(granule.chip_grid(80, 100, 32)[0])  # 12 chips
    stats = {}
    ours, _ = granule.granule_inference(tile, Marked(), MEAN, STD, chip_size=32,
                                        batch_size=batch, is_reg_task=True, stats=stats)
    assert seen == [batch] * -(-n // batch) and stats["batches"] == len(seen)
    ref, _ = granule.granule_inference(tile, port, MEAN, STD, chip_size=32, batch_size=1,
                                       is_reg_task=True)
    assert np.isfinite(ours).all() and (ours > -1e3).all()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_granule_regression_matches_jax():
    jax_model, variables, port = _models(1)
    tile = np.random.default_rng(2).uniform(1, 10, size=(6, 64, 80)).astype(np.float32)
    tile[:, :8, :8] = 0.0
    kw = dict(chip_size=32, batch_size=4, is_reg_task=True)
    ref, _ = jax_granule.granule_inference(tile, jax_model, variables, [5.0] * 6, [3.0] * 6,
                                           **kw)
    ours, _ = granule.granule_inference(tile, port, [5.0] * 6, [3.0] * 6, **kw)
    ref = np.asarray(ref)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    assert np.isnan(ours[:8, :8]).all() and not np.isnan(ours[8:, 8:]).any()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=REG_ATOL, equal_nan=True)


def test_granule_nodata_mask_uses_selected_bands(models):
    """Fill in every band the model sees, valid data in two unselected
    (QA-like) bands: the pixel is −1 on both sides."""
    jax_model, variables, port = models
    tile = np.random.default_rng(3).integers(1, 10000, size=(8, 32, 64)).astype(np.uint16)
    tile[:6, :8, :8] = 0
    tile[6:] = 7
    kw = dict(chip_size=32, batch_size=1, bands=[0, 1, 2, 3, 4, 5], no_data_value=0)
    ref, _ = jax_granule.granule_inference(tile, jax_model, variables, MEAN, STD, **kw)
    ours, _ = granule.granule_inference(tile, port, MEAN, STD, **kw)
    _assert_classes_agree(ours, np.asarray(ref),
                          _jax_gap_canvas(tile, jax_model, variables, bands=kw["bands"]))
    assert (ours[:8, :8] == -1).all() and (ours[8:, 8:] != -1).all()


def test_granule_inference_to_file(models, tmp_path):
    jax_model, variables, port = models
    tile = np.random.default_rng(4).integers(1, 10000, size=(6, 64, 70)).astype(np.uint16)
    src = str(tmp_path / "granule.tif")
    write_geotiff(src, tile, transform=Affine.from_origin(499980, 4100040, 30, 30), crs=32633,
                  nodata=0)
    ours = granule.granule_inference_to_file(src, str(tmp_path / "pred.tif"), port, MEAN, STD,
                                             chip_size=32, batch_size=4)
    ref = jax_granule.granule_inference_to_file(src, str(tmp_path / "ref.tif"), jax_model,
                                                variables, MEAN, STD, chip_size=32,
                                                batch_size=4)
    with JaxGeoTiffReader(ours) as r, JaxGeoTiffReader(ref) as q:
        assert (r.width, r.height, r.crs, r.nodata) == (q.width, q.height, q.crs, q.nodata)
        assert r.transform.to_gdal() == q.transform.to_gdal()
        assert (r.crs, r.transform.c, r.transform.f) == (32633, 499980, 4100040)
        _assert_classes_agree(r.read(1), q.read(1), _jax_gap_canvas(tile, jax_model, variables))


# ---------------------------------------------------------------------------
# Opening granules
# ---------------------------------------------------------------------------


def test_httpfile_matches_jax(tmp_path):
    arr = np.random.default_rng(0).integers(0, 10000, size=(3, 33, 47)).astype(np.uint16)
    path = str(tmp_path / "remote.tif")
    write_geotiff(path, arr, compress="deflate")
    payload = open(path, "rb").read()
    sessions, files = [], []
    for mod in (remote_io, jax_remote_io):
        sessions.append(FakeSession(payload))
        files.append(mod.HttpFile("http://x/remote.tif", session=sessions[-1], block_size=2048))
    ours, ref = files
    for f in files:
        f.seek(5000)
    assert ours.read(100) == ref.read(100)
    ours.seek(-16, os.SEEK_END)
    ref.seek(-16, os.SEEK_END)
    assert ours.read(16) == ref.read(16) == payload[-16:]
    assert ours.size == ref.size == len(payload)
    assert sessions[0].range_requests == sessions[1].range_requests
    fresh = FakeSession(payload)
    out = GeoTiffReader("http://x/remote.tif", fp=remote_io.HttpFile(
        "http://x/remote.tif", session=fresh, block_size=2048)).read()
    np.testing.assert_array_equal(out, arr)
    assert all(e - s <= 2048 for s, e in fresh.range_requests)


def test_urllib_session_error_status_is_raised():
    r = remote_io.Response("http://x/y", 404, {}, b"")
    with pytest.raises(remote_io.HTTPStatusError, match="404"):
        r.raise_for_status()
    assert isinstance(remote_io.HTTPStatusError("u", 500), remote_io.NETWORK_ERRORS)
    assert not isinstance(FileNotFoundError(), remote_io.NETWORK_ERRORS)


def _item(gid, assets, dt="2023-06-01T10:00:00Z"):
    return {"id": gid, "collection": "c", "bbox": [0, 0, 1, 1],
            "properties": {"datetime": dt, "eo:cloud_cover": 5},
            "assets": {k: {"href": v} for k, v in assets.items()}}


def _write(path, arr, origin=(499980.0, 4100040.0), res=30.0):
    write_geotiff(str(path), arr, transform=Affine.from_origin(*origin, res, res), crs=32633,
                  tiled=True, tile_size=16)
    return str(path)


def _assert_opened_equal(ours, ref):
    for o, r in zip(ours[:2], ref[:2]):
        if r is None:
            assert o is None
        else:
            assert o.dtype == r.dtype and o.shape == r.shape
            np.testing.assert_array_equal(o, r)
    assert ours[2].to_gdal() == ref[2].to_gdal() and ours[3] == ref[3]


def test_stac_item_roundtrip_and_entries():
    d = _item("HLS.S30.T33TUN.2023152T100000.v2.0", {"B02": "/a.tif"})
    ours, ref = stac.StacItem.from_dict(d), jax_stac.StacItem.from_dict(d)
    assert ours.to_dict() == ref.to_dict()
    for entry in (["a", "b"], ["a", None], ["a", "a"]):
        assert stac.is_valid_dataset_entry(entry) == jax_stac.is_valid_dataset_entry(entry)


@pytest.mark.parametrize("nesting", [True, False])
def test_open_stac_items_matches_jax(tmp_path, nesting):
    rng = np.random.default_rng(5)
    fine = rng.integers(0, 9000, (24, 24)).astype(np.uint16)
    if nesting:  # a 20 m band and mask on a 10 m grid: upsampled
        coarse = rng.integers(0, 9000, (12, 12)).astype(np.uint16)
        assets = {"B02": _write(tmp_path / "b02.tif", fine, res=10.0),
                  "B8A": _write(tmp_path / "b8a.tif", coarse, res=20.0),
                  "SCL": _write(tmp_path / "scl.tif", rng.integers(0, 11, (12, 12)).astype(
                      np.uint8), res=20.0)}
        kw = dict(bands_asset=["B02", "B8A"], mask_band="SCL", load_masks=True)
    else:  # shapes that do not nest: cropped to the common extent
        other = rng.integers(0, 9000, (20, 20)).astype(np.uint16)
        assets = {"B02": _write(tmp_path / "b02.tif", fine),
                  "B03": _write(tmp_path / "b03.tif", other, origin=(499990.0, 4100030.0))}
        kw = dict(bands_asset=["B02", "B03"], mask_band="", load_masks=False)
    tile = {"granules": [_item("S2A_MSIL2A_20230601", assets)]}
    ours = stac.open_stac_items(tile, **kw)
    ref = jax_stac.open_stac_items(tile, **kw)
    _assert_opened_equal(ours, ref)
    assert ours[0].shape == ((2, 24, 24) if nesting else (2, 20, 20))


def _hls_granule(tmp_path, gid, names, rng, shape=(40, 48)):
    assets = {}
    for name in names:
        arr = rng.integers(0, 12000, shape).astype(np.int16)  # clipped to 0..10000
        assets[name] = _write(tmp_path / f"{gid}_{name}.tif", arr)
    assets["Fmask"] = _write(tmp_path / f"{gid}_Fmask.tif",
                             rng.choice([0, 2, 8, 64], shape).astype(np.uint8))
    return _item(gid, assets)


def test_open_hls_stac_items_mixes_l30_and_s30(tmp_path):
    rng = np.random.default_rng(6)
    l30 = ["B02", "B03", "B04", "B05", "B06", "B07"]
    s30 = ["B02", "B03", "B04", "B8A", "B11", "B12"]
    granules = [_hls_granule(tmp_path, "HLS.L30.T33TUN.2023152T100000.v2.0", l30, rng),
                _hls_granule(tmp_path, "HLS.S30.T33TUN.2023162T100000.v2.0", s30, rng)]
    ours = hls.open_hls_stac_items({"granules": granules}, load_masks=True)
    ref = jax_hls.open_hls_stac_items({"granules": granules}, load_masks=True)
    _assert_opened_equal(ours, ref)
    assert ours[0].dtype == np.uint16 and ours[0].shape == (12, 40, 48)
    assert ours[0].max() <= 10000 and ours[1].shape == (2, 40, 48)
    assert_fmask = np.asarray([0, 1, 2, 3, 10, 255])
    np.testing.assert_array_equal(hls.decode_fmask_value(assert_fmask, 1),
                                  jax_hls.decode_fmask_value(assert_fmask, 1))


def test_open_s2_and_s1_stac_items(tmp_path):
    rng = np.random.default_rng(7)
    s2_assets = {n: _write(tmp_path / f"s2_{n}.tif", rng.integers(0, 9000, (24, 24)).astype(
        np.uint16)) for n in ["B02", "B03", "B04", "B8A", "B11", "B12"]}
    s2_assets["SCL"] = _write(tmp_path / "s2_scl.tif",
                              rng.integers(0, 11, (24, 24)).astype(np.uint8))
    tile = {"granules": [_item("S2A_MSIL2A_20230601T100000_R022_T33TUN", s2_assets)]}
    _assert_opened_equal(s2.open_s2_stac_items(tile, load_masks=True),
                         jax_s2.open_s2_stac_items(tile, load_masks=True))
    scl = np.asarray([[8, 9, 6, 4]])
    np.testing.assert_array_equal(s2.create_mask_from_scl(scl, [8, 9]),
                                  jax_s2.create_mask_from_scl(scl, [8, 9]))
    assert s2.MPCSigner()("/local/b02.tif") == "/local/b02.tif"

    vv = rng.standard_normal((24, 24)).astype(np.float32)
    vv[3, 4] = np.nan
    s1_assets = {"vv": _write(tmp_path / "vv.tif", vv),
                 "vh": _write(tmp_path / "vh.tif", rng.standard_normal((24, 24)).astype(
                     np.float32))}
    tile = {"granules": [_item("S1A_IW_GRDH_1SDV_20230601T100000", s1_assets)]}
    ours = s1.open_s1_stac_items(tile)
    _assert_opened_equal(ours, jax_s1.open_s1_stac_items(tile))
    assert ours[0].dtype == np.float32 and ours[0][0, 3, 4] == -1.0


def test_sliding_inference_cli_matches_jax(models, tmp_path, capsys):
    """``mode=sliding_inference device=cpu`` over a dataset JSON of two
    HLS entries (local hrefs), against JAX ``granule_inference_to_file``."""
    _sliding_inference_matches_jax(models, tmp_path, capsys,
                                   BestCheckpointer(str(tmp_path / "run")).save(models[1]))


def test_sliding_inference_reads_a_jax_checkpoint(models, tmp_path, capsys):
    """The same run on a directory the JAX package's ``BestCheckpointer``
    wrote (OCDBT, zstd)."""
    variables = models[1]
    ckpt = JaxBestCheckpointer(str(tmp_path / "jax_run"))
    ckpt.save(types.SimpleNamespace(step=np.int32(3), params=variables["params"],
                                    batch_stats=variables["batch_stats"], opt_state=None))
    _sliding_inference_matches_jax(models, tmp_path, capsys, ckpt.path)


def _sliding_inference_matches_jax(models, tmp_path, capsys, ckpt):
    jax_model, variables, _ = models
    rng = np.random.default_rng(8)
    s30 = ["B02", "B03", "B04", "B8A", "B11", "B12"]
    dataset = {}
    for i in range(2):
        g = _hls_granule(tmp_path, f"HLS.S30.T33TUN.202315{i}T100000.v2.0", s30, rng,
                         shape=(50, 70))
        dataset[f"T33TUN/entry_{i}"] = {"granules": [g]}
    # A nodata block in every band of the first entry.
    for name in s30:
        path = dataset["T33TUN/entry_0"]["granules"][0]["assets"][name]["href"]
        with GeoTiffReader(path) as r:
            arr = r.read(1)
        arr[10:20, 5:25] = 0
        _write(path, arr)
    json_path = tmp_path / "dataset.json"
    json_path.write_text(json.dumps(dataset))
    over = {"root_dir": str(tmp_path), "test_filepath": str(json_path),
            "checkpoint_path": ckpt, "model.model_name": "prithvi_eo_tiny",
            "model.depth": 2, "model.num_classes": 3, "model.load_pretrained_weights": False,
            "dataloader.img_size": 32, "dataloader.bands": [0, 1, 2, 3, 4, 5],
            "dataloader.no_data_value": 0, "dataloader.mean": MEAN, "dataloader.std": STD,
            "train.batch_size": 4, "tpu.precision": "f32", "test.data_source": "hls"}
    argv = ["mode=sliding_inference", "device=cpu"] + [
        f"{k}={json.dumps(v) if isinstance(v, list) else v}" for k, v in over.items()]
    assert run.main(argv) == 2
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # The JAX CLI's last line: train/run.py's sliding_inference mode.
    assert set(last) == {"granules", "seconds", "out_dir"} and last["granules"] == 2
    for key, entry in dataset.items():
        bands, _, transform, crs = jax_hls.open_hls_stac_items(entry, load_masks=False)
        safe = key.replace("/", "_")
        ref = jax_granule.granule_inference_to_file(
            bands, str(tmp_path / f"ref_{safe}.tif"), jax_model, variables, MEAN, STD,
            transform=transform, crs=crs, chip_size=32, batch_size=4, no_data_value=0)
        with JaxGeoTiffReader(os.path.join(last["out_dir"], f"prediction_{safe}.tif")) as r, \
                JaxGeoTiffReader(ref) as q:
            assert r.transform.to_gdal() == q.transform.to_gdal() and r.crs == q.crs == 32633
            _assert_classes_agree(r.read(1), q.read(1),
                                  _jax_gap_canvas(bands, jax_model, variables))
    with GeoTiffReader(os.path.join(last["out_dir"], "prediction_T33TUN_entry_0.tif")) as r:
        assert (r.read(1)[10:20, 5:25] == -1).all()


def test_sliding_inference_needs_cuda_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["mode=sliding_inference", f"root_dir={tmp_path}", "test_filepath=a.json",
                  "checkpoint_path=ckpt"])

