"""The port's chip ops against the JAX package's ``ops/chip_ops.py``.

Every case of ``tests/data_tests/test_chip_ops.py``, with the same inputs
through both packages: the results must be equal bit for bit and dtype for
dtype (tolerance 0), the port's on the CPU (``device="cpu"``).
"""

from unittest.mock import patch

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instageo_tpu.data.geotiff import Affine as JaxAffine
from instageo_tpu.data.pipeline import get_chip_coords as jax_get_chip_coords
from instageo_tpu.data.pipeline import point_rowcol as jax_point_rowcol
from instageo_tpu.ops import chip_ops as jco
from instageo_tpu_torch.data.geotiff import Affine
from instageo_tpu_torch.data.pipeline import get_chip_coords, point_rowcol
from instageo_tpu_torch.ops import chip_ops as tco

torch.set_num_threads(1)


def assert_same(ours, ref):
    """Equal values and equal dtype (tolerance 0)."""
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.dtype == ref.dtype, (ours.dtype, ref.dtype)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("position", [0, 1, 2, 3, 5, 7])
def test_decode_fmask_bits(position):
    m = np.asarray([[10, 0, 2, 1, 255, 128, 33]], np.int32)
    assert_same(tco.decode_fmask_value(torch.from_numpy(m), position),
                jco.decode_fmask_value(jnp.asarray(m), position))


@pytest.mark.parametrize("classes", [[8, 9], [6], [3, 8, 10]])
def test_decode_scl_classes(classes):
    m = np.asarray([[8, 9, 6, 4, 3, 10, 0]], np.uint8)
    assert_same(tco.decode_scl_mask(torch.from_numpy(m), classes),
                jco.decode_scl_mask(jnp.asarray(m), classes))
    assert_same(tco.decode_mask(torch.from_numpy(m), classes),
                jco.decode_mask(jnp.asarray(m), classes))


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.float32])
def test_extract_chips(dtype):
    tile = np.arange(2 * 10 * 12).reshape(2, 10, 12).astype(dtype)
    coords = np.asarray([[0, 0], [1, 1], [2, 1]], np.int32)  # (2, 1): clamped in x
    assert_same(tco.extract_chips(torch.from_numpy(tile), coords, 4),
                jco.extract_chips(jnp.asarray(tile), jnp.asarray(coords), 4))
    offsets = np.asarray([[0, 0], [3, 5], [9, 8], [11, 0]], np.int32)  # last two clamped
    assert_same(tco.extract_chips_px(torch.from_numpy(tile), offsets, 4),
                jco.extract_chips_px(jnp.asarray(tile), jnp.asarray(offsets), 4))


def test_uint16_tile_stays_narrow_and_widens_chip_by_chip():
    """A uint16 tile goes to the device as its int16 bit pattern (2 bytes a
    pixel); the gathered chips widen to int32 with the values the JAX
    package's chips hold, high bit included."""
    tile = np.arange(2 * 10 * 12).reshape(2, 10, 12).astype(np.uint16) * 547
    assert tile.max() > 0x7FFF
    dev = tco.tile_to_device(tile, torch.device("cpu"))
    assert dev.dtype == torch.int16 and dev.element_size() == 2
    offsets = np.asarray([[0, 0], [3, 5], [9, 8], [11, 0]], np.int32)
    ours = tco.extract_chips_px(dev, offsets, 4, uint16=True)
    assert ours.dtype == torch.int32 and ours.is_contiguous()
    ref = jco.extract_chips_px(jnp.asarray(tile), jnp.asarray(offsets), 4)
    assert_same(ours.numpy().astype(np.uint16), ref)


@pytest.mark.parametrize("strategy", ["each", "any"])
@pytest.mark.parametrize("dtype,fill", [(np.float32, -9.0), (np.int16, 0), (np.int32, -9999),
                                        (np.int16, 0.0)])
def test_apply_mask_each_vs_any(strategy, dtype, fill):
    # 2 timesteps x 2 bands; the cloud bit (1) and the shadow bit (3) at t0/t1.
    rng = np.random.default_rng(0)
    chips = rng.integers(1, 100, (2, 4, 3, 3)).astype(dtype)
    masks = rng.choice([0, 2, 8, 10, 1], size=(2, 2, 3, 3)).astype(np.int32)
    ours = tco.apply_mask(torch.from_numpy(chips), torch.from_numpy(masks), fill, "HLS",
                          ["cloud", "cloud_shadow", "unknown"], strategy)
    ref = jco.apply_mask(jnp.asarray(chips), jnp.asarray(masks), fill, "HLS",
                         ["cloud", "cloud_shadow", "unknown"], strategy)
    assert_same(ours, ref)
    with pytest.raises(ValueError, match="masking strategy"):
        tco.apply_mask(torch.from_numpy(chips), torch.from_numpy(masks), fill, "HLS",
                       ["cloud"], "all")


def test_apply_mask_scl_classes():
    chips = np.full((1, 2, 4, 4), 9.0, np.float32)
    masks = np.asarray([[[[8, 9, 6, 4]] * 4]], np.int32)
    ours = tco.apply_mask(torch.from_numpy(chips), torch.from_numpy(masks), 0.0, "S2",
                          ("cloud", "water"), "any")
    assert_same(ours, jco.apply_mask(jnp.asarray(chips), jnp.asarray(masks), 0.0, "S2",
                                     ("cloud", "water"), "any"))


def test_apply_mask_bit_position_zero():
    chips = np.full((1, 2, 4, 4), 9.0, np.float32)
    masks = np.zeros((1, 1, 4, 4), np.int32)
    masks[0, 0, 1, 1] = 1  # bit 0
    with patch.dict(jco.MASK_DECODING_POS["HLS"], {"cirrus": 0}), \
            patch.dict(tco.MASK_DECODING_POS["HLS"], {"cirrus": 0}):
        ours = tco.apply_mask(torch.from_numpy(chips), torch.from_numpy(masks), 0.0, "HLS",
                              ("cirrus",), "any")
        ref = jco.apply_mask(jnp.asarray(chips), jnp.asarray(masks), 0.0, "HLS",
                             ("cirrus",), "any")
    assert_same(ours, ref)
    assert ours[0, :, 1, 1].tolist() == [0.0, 0.0] and ours[0, 0, 0, 0] == 9.0


@pytest.mark.parametrize("window_size", [0, 1, 2])
@pytest.mark.parametrize("is_reg", [False, True])
def test_stamp_segmentation_window_and_clip(window_size, is_reg):
    rc = np.asarray([[0, 0], [3, 3], [7, 6], [9, -1]], np.int32)  # clipped at the edges
    labels = np.asarray([1.0, 2.5, -3.0, 4.0], np.float32)
    for valid in ([True, True, True, True], [True, False, True, False]):
        valid = np.asarray(valid)
        ours = tco.stamp_segmentation(torch.from_numpy(rc), torch.from_numpy(labels),
                                      torch.from_numpy(valid), 8, window_size, is_reg)
        ref = jco.stamp_segmentation(jnp.asarray(rc), jnp.asarray(labels), jnp.asarray(valid),
                                     8, window_size=window_size, is_reg=is_reg)
        assert_same(ours, ref)


@pytest.mark.parametrize("deterministic", [False, True])
def test_stamp_segmentation_later_point_wins(deterministic):
    rc = np.asarray([[5, 5], [6, 6], [5, 6], [6, 5]], np.int32)  # windows overlap
    labels = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    valid = np.ones(4, bool)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        for order in (slice(None), slice(None, None, -1)):
            ours = tco.stamp_segmentation(torch.from_numpy(rc[order].copy()),
                                          torch.from_numpy(labels[order].copy()),
                                          torch.from_numpy(valid), 32, 1)
            ref = jco.stamp_segmentation(jnp.asarray(rc[order]), jnp.asarray(labels[order]),
                                         jnp.asarray(valid), 32, window_size=1)
            assert_same(ours, ref)
            assert ours[6, 6] == labels[order][-1]
    finally:
        torch.use_deterministic_algorithms(prev)


@pytest.mark.parametrize("strategy", ["each", "any"])
def test_mask_segmentation_map_strategies(strategy):
    chip = np.asarray([[[1.0, 0.0], [1.0, 1.0]], [[0.0, 0.0], [1.0, 1.0]]], np.float32)
    seg = np.asarray([[5, 5], [5, 5]], np.int16)
    assert_same(tco.mask_segmentation_map(torch.from_numpy(chip), torch.from_numpy(seg),
                                          0.0, strategy),
                jco.mask_segmentation_map(jnp.asarray(chip), jnp.asarray(seg), 0.0, strategy))


def test_validity_reductions():
    chips = np.stack([np.zeros((2, 2, 2)), np.ones((2, 2, 2))]).astype(np.float32)
    assert_same(tco.chip_has_data(torch.from_numpy(chips), 0.0),
                jco.chip_has_data(jnp.asarray(chips), 0.0))
    segs = np.stack([np.full((2, 2), -1), [[-1, 3], [-1, -1]]]).astype(np.int16)
    assert_same(tco.seg_has_labels(torch.from_numpy(segs)),
                jco.seg_has_labels(jnp.asarray(segs)))


def test_chip_coords_and_rowcol():
    xs = np.asarray([1005.0, 1325.0, 1160.0])
    ys = np.asarray([1995.0, 1675.0, 1995.0])
    ours = get_chip_coords(xs, ys, Affine.from_origin(1000.0, 2000.0, 10.0, 10.0), 16)
    ref = jax_get_chip_coords(xs, ys, JaxAffine.from_origin(1000.0, 2000.0, 10.0, 10.0), 16)
    assert_same(ours, ref)
    assert_same(point_rowcol(xs, ys, Affine.from_origin(1000.0, 2000.0, 10.0, 10.0)),
                jax_point_rowcol(xs, ys, JaxAffine.from_origin(1000.0, 2000.0, 10.0, 10.0)))


def _both_process(*args, **kw):
    ours = tco.process_tile_chips(*args, device="cpu", **kw)
    ref = jco.process_tile_chips(*args, **kw)
    for o, r in zip(ours, ref):
        assert_same(o, r)
    return ours


@pytest.mark.parametrize("mask_types", [(), ("cloud",), ("cloud", "cloud_shadow")])
@pytest.mark.parametrize("strategy", ["each", "any"])
def test_process_tile_chips_end_to_end(mask_types, strategy):
    """A uint16 tile of 2 timesteps x 3 bands with an Fmask plane per
    timestep, an edge chip past the tile (clamped), points with windows."""
    rng = np.random.default_rng(0)
    tile = rng.integers(0, 40000, size=(6, 20, 20)).astype(np.uint16)
    tile[:, :3, :3] = 0
    masks = rng.choice([0, 2, 8, 64], size=(2, 20, 20)).astype(np.uint8)
    chip_coords = np.asarray([[0, 0], [1, 1], [2, 0]], np.int32)
    point_rc = np.asarray([[2, 3], [10, 12], [1, 17], [5, 5], [4, 4], [30, 0]], np.int64)
    labels = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], np.float32)
    owner = np.asarray([0, 1, 2, 0, 0, 7])  # the last point's chip is out of range
    chips, *_ = _both_process(
        tile, masks, chip_coords, point_rc, labels, owner, chip_size=8, no_data_value=0,
        data_source="HLS", mask_types=mask_types, masking_strategy=strategy, window_size=1)
    assert chips.dtype == np.uint16


@pytest.mark.parametrize("fill,is_reg", [(0.0, False), (0, True)])
def test_process_tile_chips_fill_and_regression_dtypes(fill, is_reg):
    rng = np.random.default_rng(1)
    tile = rng.integers(0, 5, size=(2, 16, 16)).astype(np.int16)
    masks = rng.choice([0, 2], size=(1, 16, 16)).astype(np.int32)
    rc = np.asarray([[1, 1], [9, 9], [9, 10]], np.int64)
    labels = np.asarray([0.5, 2.25, 7.0], np.float32)
    _both_process(tile, masks, np.asarray([[0, 0], [1, 1]]), rc, labels, np.asarray([0, 1, 1]),
                  chip_size=8, no_data_value=fill, mask_types=("cloud",), window_size=0,
                  is_reg=is_reg)


def test_process_tile_chips_dense_raster_never_drops():
    cs = 32
    tile = np.full((1, cs, cs), 50.0, np.float32)
    rr, cc = np.meshgrid(np.arange(cs), np.arange(cs), indexing="ij")
    rc = np.stack([rr.ravel(), cc.ravel()], axis=1).astype(np.int64)
    labels = (rc[:, 0] * cs + rc[:, 1]).astype(np.float32) % 7
    _, segs, _, sv = _both_process(
        tile, None, np.array([[0, 0]], np.int32), rc, labels, np.zeros(len(rc), np.int64),
        chip_size=cs, no_data_value=0, mask_types=(), masking_strategy="each",
        window_size=0, max_points_per_chip=512)
    assert sv.all()
    np.testing.assert_array_equal(segs[0], labels.reshape(cs, cs).astype(np.int16))


def test_process_tile_chips_random_points_match_sequential_stamping():
    rng = np.random.default_rng(7)
    cs, side, n_pts = 16, 2, 10_000
    h = w = cs * side
    tile = np.full((1, h, w), 3.0, np.float32)
    coords = np.array([[x, y] for y in range(side) for x in range(side)], np.int32)
    rc = np.stack([rng.integers(0, h, n_pts), rng.integers(0, w, n_pts)], axis=1)
    labels = rng.integers(0, 9, n_pts).astype(np.float32)
    owner = (rc[:, 0] // cs) * side + rc[:, 1] // cs
    _, segs, _, _ = _both_process(
        tile, None, coords, rc.astype(np.int64), labels, owner, chip_size=cs,
        no_data_value=0, mask_types=(), masking_strategy="each", window_size=0,
        max_points_per_chip=64)
    expected = np.full((len(coords), cs, cs), -1, np.int16)
    for (r, c), lab, ci in zip(rc, labels, owner):
        expected[ci, r - coords[ci, 1] * cs, c - coords[ci, 0] * cs] = lab
    np.testing.assert_array_equal(segs, expected)


@pytest.mark.parametrize("window_size", [0, 1])
def test_process_tile_chips_mixed_density_buckets(window_size):
    """Chip 0 dense (every pixel), chip 2 of 20 points, the rest sparse: three
    power-of-two buckets at a cap of 8."""
    rng = np.random.default_rng(11)
    cs, side = 16, 2
    tile = rng.integers(0, 3, size=(2, cs * side, cs * side)).astype(np.uint16)
    coords = np.array([[x, y] for y in range(side) for x in range(side)], np.int32)
    rr, cc = np.meshgrid(np.arange(cs), np.arange(cs), indexing="ij")
    pts, owners = [np.stack([rr.ravel(), cc.ravel()], axis=1)], [np.zeros(cs * cs, np.int64)]
    for ci, k in ((1, 3), (2, 20), (3, 3)):
        r0, c0 = coords[ci, 1] * cs, coords[ci, 0] * cs
        pts.append(np.stack([rng.integers(0, cs, k) + r0, rng.integers(0, cs, k) + c0], 1))
        owners.append(np.full(k, ci, np.int64))
    rc = np.concatenate(pts).astype(np.int64)
    labels = rng.integers(0, 9, len(rc)).astype(np.float32)
    _both_process(tile, None, coords, rc, labels, np.concatenate(owners), chip_size=cs,
                  no_data_value=0, mask_types=(), masking_strategy="any",
                  window_size=window_size, max_points_per_chip=8)


def test_process_tile_chips_runs_on_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tco.process_tile_chips(np.zeros((1, 8, 8), np.float32), None, np.zeros((1, 2), int),
                               np.zeros((0, 2), int), np.zeros(0, np.float32),
                               np.zeros(0, int), chip_size=8, no_data_value=0)
