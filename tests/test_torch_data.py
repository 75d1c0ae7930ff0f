"""Parity of the port's chip data pipeline with the JAX package's.

The same chips (written with the port's GeoTIFF writer) and the same seeded
``np.random.Generator`` go through the JAX function and the port's.
Tolerances: exact (array_equal) for ``process_data``,
``normalize_and_reshape``, ``process_test``, the collates,
``get_valid_filepaths``, the crops and hflip / vflip / brightness / noise;
blur within 1e-5 of ``max_pixel_value`` (float32 separable sums in another
order); rotation: at least 99% of pixels equal in each plane, since
OpenCV's coordinate rounding at half-pixels is not reproduced bit for bit
(the least share is printed: 1.0 on these inputs against OpenCV 5.0).
"""

import csv
from functools import partial

import numpy as np
import pytest
import torch

from instageo_tpu.data import dataloader as jdl
from instageo_tpu_torch.data import dataloader as pdl
from instageo_tpu_torch.data.geotiff import Affine, write_geotiff

MAX_PIXEL = 10000.0
BLUR_ATOL = 1e-5 * MAX_PIXEL
ROTATE_MIN_SHARE = 0.99
AUGS = [
    {"name": "hflip", "p": 0.5}, {"name": "vflip", "p": 0.5},
    {"name": "rotate", "p": 0.5, "degrees": 10},
    {"name": "brightness", "p": 0.5, "brightness_range": [0.8, 1.2],
     "contrast_range": [0.8, 1.2]},
    {"name": "blur", "p": 0.5, "kernel_size": 3, "sigma_range": [0.1, 2.0]},
    {"name": "noise", "p": 0.5, "noise_std": 0.05},
]
MEAN = [900.0, 1100.0, 1300.0]
STD = [400.0, 500.0, 600.0]


def _stack(seed, shape=(6, 40, 36)):
    return np.random.default_rng(seed).integers(0, 12000, shape).astype(np.float32)


@pytest.fixture(scope="module")
def chips(tmp_path_factory):
    """6 chips of 6 bands (2 frames x 3), 40 px, with labels 0..3, and a
    CSV that also lists a missing chip, an unreadable one and one whose
    label is all ignored (-1)."""
    root = tmp_path_factory.mktemp("chips")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(6):
        arr = rng.integers(1, 10000, (6, 40, 40)).astype(np.uint16)
        arr[:, :3, :5] = 0  # no data in a corner
        lab = rng.integers(0, 4, (40, 40)).astype(np.int16)
        lab[0] = -9999
        if i == 5:
            lab[:] = -1
        tr = Affine.from_origin(500000 + 1200 * i, 4100000, 30, 30)
        write_geotiff(str(root / f"a_{i}_chip.tif"), arr, transform=tr, crs=32633, nodata=0)
        write_geotiff(str(root / f"a_{i}_label.tif"), lab[None], transform=tr, crs=32633)
        rows.append({"Input": f"a_{i}_chip.tif", "Label": f"a_{i}_label.tif"})
    (root / "bad_chip.tif").write_bytes(b"not a tiff")
    rows += [{"Input": "missing_chip.tif", "Label": "a_0_label.tif"},
             {"Input": "bad_chip.tif", "Label": "a_0_label.tif"}]
    with open(root / "chips.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, ["Input", "Label"])
        writer.writeheader()
        writer.writerows(rows)
    with open(root / "inputs.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, ["Input"])
        writer.writeheader()
        writer.writerows({"Input": r["Input"]} for r in rows[:3])
    return root


def test_valid_filepaths_and_process_data_match_jax(chips):
    for csv_name in ("chips.csv", "inputs.csv"):
        ours = pdl.get_valid_filepaths(str(chips / csv_name), str(chips), 0, -1)
        ref = jdl.get_valid_filepaths(str(chips / csv_name), str(chips), 0, -1)
        assert ours == ref
    assert len(ours) == 3 and len(pdl.get_valid_filepaths(
        str(chips / "chips.csv"), str(chips), 0, -1)) == 5  # all-ignored label dropped
    im, lab = str(chips / "a_1_chip.tif"), str(chips / "a_1_label.tif")
    for kw in (dict(), dict(reduce_to_zero=True, bands=[0, 2, 4], constant_multiplier=0.5),
               dict(replace_label=(-9999, -1), bands=[5, 4, 3, 2, 1, 0])):
        ours, ref = pdl.process_data(im, lab, **kw), jdl.process_data(im, lab, **kw)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    nan_chip = chips / "nan_chip.tif"
    data = np.random.default_rng(1).standard_normal((2, 8, 8)).astype(np.float32)
    data[0, 0, :4] = np.nan
    write_geotiff(str(nan_chip), data)
    np.testing.assert_array_equal(pdl.process_data(str(nan_chip))[0],
                                  jdl.process_data(str(nan_chip))[0])


@pytest.mark.parametrize("name", ["hflip", "vflip", "brightness", "noise"])
def test_exact_augmentations_match_jax(name):
    aug = [dict(next(a for a in AUGS if a["name"] == name), p=1.0)]
    for seed in range(3):
        x, y = _stack(seed), np.random.default_rng(seed).integers(0, 4, (40, 36)).astype(np.float32)
        ours = pdl.random_augs(x, y, np.random.default_rng(seed), aug, max_pixel_value=MAX_PIXEL)
        ref = jdl.random_augs(x, y, np.random.default_rng(seed), aug, max_pixel_value=MAX_PIXEL)
        np.testing.assert_array_equal(ours[0], ref[0])
        np.testing.assert_array_equal(ours[1], ref[1])


def test_blur_matches_jax():
    aug = [dict(AUGS[4], p=1.0)]
    for seed in range(4):
        x = _stack(seed)
        ours = pdl.random_augs(x, None, np.random.default_rng(seed), aug)[0]
        ref = jdl.random_augs(x, None, np.random.default_rng(seed), aug)[0]
        np.testing.assert_allclose(ours, ref, rtol=0, atol=BLUR_ATOL)


def test_rotation_matches_jax():
    aug = [dict(AUGS[2], p=1.0)]
    shares = []
    for seed in range(6):
        x = _stack(seed, (3, 224, 224) if seed < 2 else (6, 40, 36))
        y = np.random.default_rng(seed).integers(0, 4, x.shape[1:]).astype(np.float32)
        ours = pdl.random_augs(x, y, np.random.default_rng(seed), aug, chip_no_data_value=0,
                               label_no_data_value=-1)
        ref = jdl.random_augs(x, y, np.random.default_rng(seed), aug, chip_no_data_value=0,
                              label_no_data_value=-1)
        planes = np.concatenate([ours[0], ours[1][None]]) == np.concatenate(
            [ref[0], ref[1][None]])
        shares.append(planes.mean(axis=(1, 2)).min())
    print(f"rotation: least share of equal pixels in a plane {min(shares):.6f}")
    assert min(shares) >= ROTATE_MIN_SHARE


def test_process_and_augment_matches_jax():
    """Random crop and the whole configured chain: the draws stay in step,
    so every pixel off the rotation's half-pixel ties agrees within the
    blur's tolerance."""
    for seed in range(4):
        x = _stack(seed)
        y = np.random.default_rng(seed).integers(0, 4, (1, 40, 36)).astype(np.float32)
        for crop, augs in ((True, None), ("center", None), (True, AUGS)):
            kw = dict(temporal_size=2, im_size=32, crop=crop, augmentations=augs)
            ours = pdl.process_and_augment(x, y, MEAN, STD, rng=np.random.default_rng(seed), **kw)
            ref = jdl.process_and_augment(x, y, MEAN, STD, rng=np.random.default_rng(seed), **kw)
            if augs is None:
                np.testing.assert_array_equal(ours[0], ref[0])
                np.testing.assert_array_equal(ours[1], ref[1])
            else:
                close = np.isclose(ours[0], ref[0], rtol=0, atol=BLUR_ATOL / np.min(STD))
                assert close.mean() >= ROTATE_MIN_SHARE
                assert (ours[1] == ref[1]).mean() >= ROTATE_MIN_SHARE


def test_normalize_process_test_and_collates_match_jax():
    x, y = _stack(7, (6, 64, 64)), _stack(8, (64, 64))
    np.testing.assert_array_equal(pdl.normalize_and_reshape(x, MEAN, STD, 2),
                                  jdl.normalize_and_reshape(x, MEAN, STD, 2))
    kw = dict(temporal_size=2, img_size=64, crop_size=32, stride=16)
    ours, ref = pdl.process_test(x, y, MEAN, STD, **kw), jdl.process_test(x, y, MEAN, STD, **kw)
    assert ours[0].shape == (9, 3, 2, 32, 32)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    samples = [ours, ref]
    for fn in ("default_collate", "eval_collate"):
        for a, b in zip(getattr(pdl, fn)(samples), getattr(jdl, fn)(samples)):
            np.testing.assert_array_equal(a, b)
    infer = [((x[:3], None), "f0", x[0] == 0), ((x[3:], None), "f1", x[1] == 0)]
    for a, b in zip(pdl.infer_collate(infer), jdl.infer_collate(infer)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _dataset(chips, mod, seed=None, **kw):
    pre = pdl.process_and_augment if mod is pdl else jdl.process_and_augment
    from functools import partial

    extra = {"seed": seed} if mod is pdl else {}
    return mod.InstaGeoDataset(
        str(chips / "chips.csv"), str(chips),
        partial(pre, mean=MEAN * 2, std=STD * 2, temporal_size=1, im_size=32, **kw),
        chip_no_data_value=0, label_no_data_value=-1, replace_label=(-9999, -1),
        reduce_to_zero=False, constant_multiplier=1.0, **extra)


def test_loader_batches_match_jax_and_are_seeded(chips):
    """Without augmentation (centre crop), the port's DataLoader batches
    equal the JAX dataset's samples stacked. With augmentation, the batches
    depend only on (seed, epoch): equal across loaders and worker counts,
    different from one epoch to the next."""
    ours = pdl.create_dataloader(_dataset(chips, pdl, crop="center"), 2, num_workers=0)
    ref = _dataset(chips, jdl, crop="center")
    got = list(ours)
    assert len(got) == 3 and all(isinstance(t, torch.Tensor) for t in got[0])
    x = torch.cat([b[0] for b in got]).numpy()
    y = torch.cat([b[1] for b in got]).numpy()
    np.testing.assert_array_equal(x, np.stack([ref[i][0] for i in range(len(ref))]))
    np.testing.assert_array_equal(y, np.stack([ref[i][1] for i in range(len(ref))]))

    def epochs(workers):
        ds = _dataset(chips, pdl, seed=5, augmentations=AUGS)
        loader = pdl.create_dataloader(ds, 2, shuffle=True, num_workers=workers, seed=3)
        return [torch.cat([b[0] for b in loader]).numpy() for _ in range(2)]

    a, b, c = epochs(0), epochs(0), epochs(2)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], c[1])
    assert not np.array_equal(a[0], a[1])


def test_cache_dir_dataset_matches_uncached(chips, tmp_path):
    """``cache_dir`` is honoured: the QA scan keeps the same rows and every
    sample equals the uncached one, cold and warm; the cache then holds the
    kept rows' chips and labels only."""
    def dataset(cache_dir):
        pre = partial(pdl.process_and_augment, mean=MEAN, std=STD, im_size=32,
                      augmentations=AUGS)
        return pdl.InstaGeoDataset(str(chips / "chips.csv"), str(chips), pre, 0, -1, None,
                                   False, 1.0, bands=[0, 2, 4], cache_dir=cache_dir, seed=3)

    cache = str(tmp_path / "cache")
    plain, cached = dataset(None), dataset(cache)
    assert cached.file_paths == plain.file_paths and len(plain) == 5
    assert len(list((tmp_path / "cache").iterdir())) == 2 * len(plain)
    for i in range(len(plain)):
        for _ in range(2):
            for a, b in zip(plain[(1, i)], cached[(1, i)]):
                np.testing.assert_array_equal(a, b)
