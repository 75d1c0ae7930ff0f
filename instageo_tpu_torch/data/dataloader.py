"""Chip dataset, preprocessing and augmentation, and the torch DataLoader.

Counterpart of ``instageo_tpu/data/dataloader.py`` with the same functions
and semantics:

* ``process_data``: band select -> constant multiply; label replace/reduce;
* ``random_augs``: hflip / vflip / rotate / brightness / blur / noise in the
  config's order, vectorised over the (T*C, H, W) stack, with the same
  probability and parameter surface and the same draws from the ``rng``;
* ``process_and_augment``: random (or centre) crop -> augs -> per-frame
  normalise -> (C, T, H, W);
* ``process_test``: sliding-window crops stacked to (N, C, T, h, w);
* ``get_valid_filepaths``: the chip CSV's QA scan;
* the decoded-chip cache (``cache_dir``): each full raster decoded once
  and kept as a ``.npy`` file keyed by (path hash, ``mtime_ns``, size).

Full rasters decode with the port's native decoder (``native/``) where it
builds, else with the Python codec (``data/geotiff.py``).

The port uses neither OpenCV nor pandas: the rotation is nearest-neighbour
in numpy with OpenCV's ``warpAffine`` coordinate arithmetic, the blur a
separable Gaussian with ``getGaussianKernel``'s taps and reflect-101
borders, and the CSV goes through the ``csv`` module.

Batches come from ``create_dataloader``: worker threads in this process
(``worker_mode="thread"``, the configs' setting), spawned worker processes
of a ``torch.utils.data.DataLoader`` (``"process"``), or the caller's own
thread (no workers). Workers run only numpy: data reaches the device in the
trainer. Augmentation draws come from a numpy ``Generator`` seeded from
(seed, epoch, index), so the batches are the same whatever the worker mode
and count.
"""

from __future__ import annotations

import csv
import glob
import hashlib
import logging
import math
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

from instageo_tpu_torch.data.geotiff import GeoTiffReader

log = logging.getLogger(__name__)

WORKER_MODES = ("thread", "process")


# ---------------------------------------------------------------------------
# Raster reading / label handling
# ---------------------------------------------------------------------------


def _read_full(fname: str) -> np.ndarray:
    """Full-raster decode: the native decoder when it builds, the Python
    codec else (and for a file the native decoder refuses)."""
    from instageo_tpu_torch import native

    if native.available():
        try:
            return native.read_geotiff_native(fname)
        except (OSError, RuntimeError, KeyError):
            pass  # the Python codec decides
    with GeoTiffReader(fname) as src:
        data = src.read()
    native.fallback_decodes.add()
    return data


def _cache_key_prefix(fname: str) -> str:
    return hashlib.sha1(os.path.abspath(fname).encode()).hexdigest()[:20]


def _read_full_cached(fname: str, cache_dir: str) -> np.ndarray:
    """The full decoded raster through the decoded-chip cache.

    Entries are ``np.save`` files named by (path hash, ``mtime_ns``, size),
    so a rewritten source misses its old entry. A miss or a corrupt entry
    decodes and writes the entry: to a temporary name, then
    ``os.replace``, so concurrent loader threads and processes never read a
    partial file; then the entries of older versions of the same source
    are pruned (strictly older ``mtime_ns`` only: a writer holding an older
    stat must not delete a peer's entry for a newer version). A cache
    directory that cannot be written degrades to decoding. Band selection
    and scaling stay outside the cache, so an entry serves every config.
    """
    try:
        st = os.stat(fname)
    except OSError:
        return _read_full(fname)
    h = _cache_key_prefix(fname)
    key = f"{h}_{st.st_mtime_ns}_{st.st_size}.npy"
    path = os.path.join(cache_dir, key)
    try:
        return np.load(path)
    except (OSError, ValueError, EOFError):
        pass  # a miss, or a corrupt entry: decode and (over)write it
    data = _read_full(fname)
    tmp = f"{path}.tmp{os.getpid()}_{threading.get_ident()}"
    try:
        os.makedirs(cache_dir, exist_ok=True)
        with open(tmp, "wb") as f:  # a file object: np.save(str) would append .npy
            np.save(f, data)
        os.replace(tmp, path)
        for old in glob.glob(os.path.join(cache_dir, f"{h}_*.npy")):
            base = os.path.basename(old)
            if base == key:
                continue
            try:
                if int(base.split("_")[1]) > st.st_mtime_ns:
                    continue
            except (IndexError, ValueError):
                pass  # a malformed name is stale
            try:
                os.remove(old)
            except OSError:
                pass
    except OSError as e:
        log.warning("chip cache write failed (%s); continuing uncached", e)
        try:
            os.remove(tmp)
        except OSError:
            pass
    return data


def _evict_cached(fname: str, cache_dir: Optional[str]) -> None:
    """Drop every cache entry of ``fname`` (any version): the QA scan calls
    it for the rows it drops, which no sample ever reads."""
    if not cache_dir:
        return
    for old in glob.glob(os.path.join(cache_dir, f"{_cache_key_prefix(fname)}_*.npy")):
        try:
            os.remove(old)
        except OSError:
            pass


def get_raster_data(fname: str, is_label: bool = True,
                    bands: Optional[Sequence[int]] = None,
                    cache_dir: Optional[str] = None) -> np.ndarray:
    """Read a raster to (bands, H, W), through the decoded-chip cache with
    ``cache_dir``; select bands for imagery."""
    data = _read_full_cached(fname, cache_dir) if cache_dir else _read_full(fname)
    if (not is_label) and bands:
        data = data[list(bands), ...]
    return data


def process_data(
    im_fname: str,
    mask_fname: Optional[str] = None,
    no_data_value: Optional[float] = -9999,
    reduce_to_zero: bool = False,
    replace_label: Optional[Tuple] = None,
    bands: Optional[Sequence[int]] = None,
    constant_multiplier: float = 1.0,
    cache_dir: Optional[str] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Load and preprocess an (image, label) pair."""
    arr_x = get_raster_data(im_fname, is_label=False, bands=bands, cache_dir=cache_dir)
    if no_data_value is not None and np.issubdtype(arr_x.dtype, np.floating):
        # Float rasters (S1 chips) carry NaN for missing pixels.
        arr_x = np.nan_to_num(arr_x, nan=no_data_value)
    arr_x = arr_x * constant_multiplier
    arr_y = None
    if mask_fname:
        arr_y = get_raster_data(mask_fname, cache_dir=cache_dir)
        if replace_label:
            arr_y = np.where(arr_y == replace_label[0], replace_label[1], arr_y)
        if reduce_to_zero:
            arr_y = arr_y - 1
    return arr_x, arr_y


def mask_label_with_chip(
    chips_path: str,
    labels_path: str,
    chip_no_data_value: float = 0,
    label_no_data_value: float = -1,
    bands_per_step: int = 6,
    cache_dir: Optional[str] = None,
) -> bool:
    """True if the label has no valid pixel under the chip's data mask
    (band ``6·i + 1`` of each timestep must hold data). With ``cache_dir``
    the scan reads full rasters through the cache, so the decode it pays
    here is the one the samples reuse."""
    if cache_dir:
        full = _read_full_cached(chips_path, cache_dir)
        num_steps = max(1, full.shape[0] // bands_per_step)
        stacked = full[[bands_per_step * i for i in range(num_steps)]]
    else:
        with GeoTiffReader(chips_path) as src:
            num_steps = max(1, src.count // bands_per_step)
            stacked = src.read([bands_per_step * i + 1 for i in range(num_steps)])
    stacked = np.where(stacked == chip_no_data_value, 0, 1).all(0)
    if cache_dir:
        label = _read_full_cached(labels_path, cache_dir)[0].astype(np.float64)
    else:
        with GeoTiffReader(labels_path) as src:
            label = src.read(1).astype(np.float64)
    label = np.where(label == label_no_data_value, np.nan, label)
    label = np.where(stacked == 0, np.nan, label)
    return bool(np.all(np.isnan(label)))


def _read_chip_csv(fname: str) -> Tuple[List[Dict[str, str]], bool]:
    with open(fname, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        return rows, "Label" in (reader.fieldnames or [])


def get_valid_filepaths(
    fname: str,
    input_root: str,
    no_data_value: float = -9999,
    ignore_index: float = -1,
    cache_dir: Optional[str] = None,
) -> List[Tuple[str, Optional[str]]]:
    """QA scan over the chip CSV (``Input``/``Label`` columns, paths
    relative to ``input_root``): drops rows whose chip is missing or
    unreadable or whose label has no valid pixel, and evicts the cache
    entries of the rows it drops."""
    file_paths: List[Tuple[str, Optional[str]]] = []
    rows, label_present = _read_chip_csv(fname)
    for row in rows:
        im_path = os.path.join(input_root, str(row["Input"]))
        mask_path = os.path.join(input_root, str(row["Label"])) if label_present else None
        if not os.path.exists(im_path):
            continue
        try:
            with GeoTiffReader(im_path):
                pass
            if mask_path is None:
                file_paths.append((im_path, None))
            elif not mask_label_with_chip(im_path, mask_path,
                                          chip_no_data_value=no_data_value,
                                          label_no_data_value=ignore_index,
                                          cache_dir=cache_dir):
                file_paths.append((im_path, mask_path))
            else:
                _evict_cached(im_path, cache_dir)
                _evict_cached(mask_path, cache_dir)
        except Exception as e:  # an unreadable chip is dropped, as in the reference
            log.error("%s: %s", im_path, e)
            _evict_cached(im_path, cache_dir)
    log.info("Dropped a total of %d rows", len(rows) - len(file_paths))
    return file_paths


# ---------------------------------------------------------------------------
# Augmentations (vectorised over the (T*C, H, W) stack)
# ---------------------------------------------------------------------------


def rotation_matrix(center: Tuple[float, float], angle: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, 1.0)``: (2, 3), degrees,
    counter-clockwise."""
    a = math.radians(angle)
    alpha, beta = math.cos(a), math.sin(a)
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _rotate_stack(stack: np.ndarray, angle: float, fill: float) -> np.ndarray:
    """Rotate every plane about ((w-1)/2, (h-1)/2), nearest neighbour,
    ``fill`` outside. Source coordinates as OpenCV 5's ``warpAffine``
    computes them for INTER_NEAREST: the matrix inverted in float64, the
    coordinates in float32, rounded to the nearest pixel (OpenCV 4's
    fixed-point arithmetic rounds some half-pixels the other way)."""
    h, w = stack.shape[-2:]
    m = rotation_matrix(((w - 1) / 2.0, (h - 1) / 2.0), angle)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    inv = np.empty((2, 3))
    inv[0, 0], inv[1, 1] = m[1, 1] * d, m[0, 0] * d
    inv[0, 1], inv[1, 0] = -m[0, 1] * d, -m[1, 0] * d
    inv[0, 2] = -inv[0, 0] * m[0, 2] - inv[0, 1] * m[1, 2]
    inv[1, 2] = -inv[1, 0] * m[0, 2] - inv[1, 1] * m[1, 2]
    inv = inv.astype(np.float32)
    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    sx = np.rint(inv[0, 0] * xs + (inv[0, 1] * ys + inv[0, 2])).astype(np.int64)
    sy = np.rint(inv[1, 0] * xs + (inv[1, 1] * ys + inv[1, 2])).astype(np.int64)
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    planes = stack.astype(np.float32)
    out = planes[:, np.clip(sy, 0, h - 1), np.clip(sx, 0, w - 1)]
    out[:, ~inside] = np.float32(fill)
    return out


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)`` taps (sigma > 0), float32."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _gaussian_blur(planes: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """Separable Gaussian blur of (N, H, W) float32 planes, rows then
    columns, with reflect-101 borders (``cv2.GaussianBlur``'s default)."""
    k = gaussian_kernel(ksize, sigma)
    r = ksize // 2
    h, w = planes.shape[-2:]
    padded = np.pad(planes, ((0, 0), (0, 0), (r, r)), mode="reflect")
    rows = sum(k[i] * padded[..., i:i + w] for i in range(ksize))
    padded = np.pad(rows, ((0, 0), (r, r), (0, 0)), mode="reflect")
    return sum(k[i] * padded[:, i:i + h] for i in range(ksize)).astype(np.float32)


def random_augs(
    ims: np.ndarray,
    label: Optional[np.ndarray],
    rng: np.random.Generator,
    augmentations: Optional[List[Dict[str, Any]]],
    chip_no_data_value: float = 0,
    label_no_data_value: float = -1,
    max_pixel_value: float = 10000.0,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Apply the configured augmentations in order; every draw comes from
    ``rng`` in the JAX package's order."""
    if not augmentations:
        return ims, label
    ims = ims.astype(np.float32)
    for aug in augmentations:
        name = aug["name"]
        p = float(aug.get("p", 0.5))
        if rng.random() >= p:
            continue
        if name == "hflip":
            ims = ims[..., ::-1].copy()
            if label is not None:
                label = label[..., ::-1].copy()
        elif name == "vflip":
            ims = ims[..., ::-1, :].copy()
            if label is not None:
                label = label[..., ::-1, :].copy()
        elif name == "rotate":
            degrees = float(aug.get("degrees", 15))
            angle = rng.uniform(-degrees, degrees)
            ims = _rotate_stack(ims, angle, chip_no_data_value)
            if label is not None:
                label = _rotate_stack(
                    label[None].astype(np.float32), angle, label_no_data_value)[0]
        elif name == "brightness":
            bright = rng.uniform(*aug.get("brightness_range", (0.8, 1.2)))
            contrast = rng.uniform(*aug.get("contrast_range", (0.8, 1.2)))
            ims = ims * bright
            mean = ims.mean(axis=(-2, -1), keepdims=True)  # per band
            ims = np.clip((ims - mean) * contrast + mean, 0, max_pixel_value)
        elif name == "blur":
            k = int(aug.get("kernel_size", 3))
            sigma = rng.uniform(*aug.get("sigma_range", (0.1, 2.0)))
            arr = np.clip(ims, 0, max_pixel_value) / max_pixel_value
            arr = _gaussian_blur(arr.astype(np.float32), k, sigma)
            ims = np.clip(arr, 0.0, 1.0) * max_pixel_value
        elif name == "noise":
            std = float(aug.get("noise_std", 0.05))
            arr = np.clip(ims, 0, max_pixel_value)
            arr *= np.float32(1.0 / max_pixel_value)
            noise = rng.standard_normal(arr.shape, dtype=np.float32)
            noise *= np.float32(std)
            arr += noise
            np.clip(arr, 0.0, 1.0, out=arr)
            arr *= np.float32(max_pixel_value)
            ims = arr
        else:
            raise ValueError(f"Unknown augmentation {name!r}")
    return ims, label


# ---------------------------------------------------------------------------
# Processing to model inputs
# ---------------------------------------------------------------------------


def normalize_and_reshape(
    ims: np.ndarray,
    mean: Sequence[float],
    std: Sequence[float],
    temporal_size: int = 1,
) -> np.ndarray:
    """(T·C, H, W) -> normalised (C, T, H, W)."""
    tc, h, w = ims.shape
    c = tc // temporal_size
    ims = ims.reshape(temporal_size, c, h, w).astype(np.float32)
    mean_arr = np.asarray(mean, np.float32)[None, :, None, None]
    std_arr = np.asarray(std, np.float32)[None, :, None, None]
    ims = (ims - mean_arr) / std_arr
    return np.ascontiguousarray(ims.transpose(1, 0, 2, 3))


def random_crop(ims: np.ndarray, label: Optional[np.ndarray], im_size: int,
                rng: np.random.Generator) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    h, w = ims.shape[-2:]
    if h == im_size and w == im_size:
        return ims, label
    top = int(rng.integers(0, h - im_size + 1))
    left = int(rng.integers(0, w - im_size + 1))
    ims = ims[..., top : top + im_size, left : left + im_size]
    if label is not None:
        label = label[..., top : top + im_size, left : left + im_size]
    return ims, label


def process_and_augment(
    x: np.ndarray,
    y: Optional[np.ndarray],
    mean: Sequence[float],
    std: Sequence[float],
    temporal_size: int = 1,
    im_size: int = 224,
    crop=True,
    label_no_data_value: float = -1,
    chip_no_data_value: float = 0,
    max_pixel_value: float = 10000.0,
    augmentations: Optional[List[Dict[str, Any]]] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Train-time preprocessing. ``crop``: True (random crop), "center"
    (the inference window that ``save_prediction`` anchors to) or False."""
    rng = rng or np.random.default_rng()
    ims = np.asarray(x)
    label = None if y is None else np.asarray(y, np.float32).squeeze()
    if crop == "center":
        h, w = ims.shape[-2:]
        top, left = (h - im_size) // 2, (w - im_size) // 2
        ims = ims[..., top:top + im_size, left:left + im_size]
        if label is not None:
            label = label[..., top:top + im_size, left:left + im_size]
    elif crop:
        ims, label = random_crop(ims, label, im_size, rng)
    ims, label = random_augs(
        ims, label, rng, augmentations,
        chip_no_data_value=chip_no_data_value,
        label_no_data_value=label_no_data_value,
        max_pixel_value=max_pixel_value,
    )
    ims = normalize_and_reshape(ims, mean, std, temporal_size)
    return ims, label


def crop_array(arr: np.ndarray, left: int, top: int, right: int, bottom: int) -> np.ndarray:
    """Crop the last two (spatial) dims of a 2D/3D/4D array."""
    if arr.ndim == 2:
        return arr[top:bottom, left:right]
    if arr.ndim in (3, 4):
        return arr[..., top:bottom, left:right]
    raise ValueError("Input array must be 2D, 3D or 4D")


def process_test(
    x: np.ndarray,
    y: np.ndarray,
    mean: Sequence[float],
    std: Sequence[float],
    temporal_size: int = 1,
    img_size: int = 512,
    crop_size: int = 224,
    stride: int = 224,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding-window eval crops -> (N, C, T, h, w), (N, h, w)."""
    imgs, labels = [], []
    for top in range(0, img_size - crop_size + 1, stride):
        for left in range(0, img_size - crop_size + 1, stride):
            bottom, right = top + crop_size, left + crop_size
            xi = crop_array(x, left, top, right, bottom)
            yi = crop_array(y, left, top, right, bottom)
            xi, yi = process_and_augment(
                xi, yi, mean, std, temporal_size, im_size=crop_size, crop=False,
                augmentations=None,
            )
            imgs.append(xi)
            labels.append(yi)
    return np.stack(imgs), np.stack(labels)


# ---------------------------------------------------------------------------
# Dataset, collates, loader
# ---------------------------------------------------------------------------


class InstaGeoDataset(Dataset):
    """CSV-driven chip dataset with the validity QA scan.

    ``seed``: when set, ``preprocess_func`` gets ``rng=``, a numpy
    Generator seeded from (seed, epoch, index); the index may be an int
    (epoch 0) or an (epoch, index) pair, as ``EpochSampler`` yields.
    ``cache_dir``: the decoded-chip cache of the QA scan and the samples.
    """

    def __init__(
        self,
        filename: str,
        input_root: str,
        preprocess_func: Callable,
        chip_no_data_value: float,
        label_no_data_value: float,
        replace_label: Optional[Tuple],
        reduce_to_zero: bool,
        constant_multiplier: float,
        bands: Optional[Sequence[int]] = None,
        include_filenames: bool = False,
        cache_dir: Optional[str] = None,
        seed: Optional[int] = None,
    ) -> None:
        self.input_root = input_root
        self.preprocess_func = preprocess_func
        self.bands = list(bands) if bands else None
        self.cache_dir = cache_dir
        self.file_paths = get_valid_filepaths(
            filename, input_root, chip_no_data_value, label_no_data_value,
            cache_dir=cache_dir)
        self.no_data_value = chip_no_data_value
        self.replace_label = replace_label
        self.reduce_to_zero = reduce_to_zero
        self.constant_multiplier = constant_multiplier
        self.include_filenames = include_filenames
        self.seed = seed

    def __len__(self) -> int:
        return len(self.file_paths)

    def __getitem__(self, key):
        epoch, i = key if isinstance(key, tuple) else (0, key)
        im_fname, mask_fname = self.file_paths[i]
        arr_x, arr_y = process_data(
            im_fname, mask_fname,
            no_data_value=self.no_data_value,
            replace_label=self.replace_label,
            reduce_to_zero=self.reduce_to_zero,
            bands=self.bands,
            constant_multiplier=self.constant_multiplier,
            cache_dir=self.cache_dir,
        )
        if self.seed is None:
            sample = self.preprocess_func(arr_x, arr_y)
        else:
            rng = np.random.default_rng([self.seed, epoch, i])
            sample = self.preprocess_func(arr_x, arr_y, rng=rng)
        if self.include_filenames:
            # process_data applied constant_multiplier, so the no-data
            # sentinel is compared in the scaled domain.
            nodata = self.no_data_value * self.constant_multiplier
            return sample, im_fname, arr_x == nodata
        return sample


def default_collate(samples: List[Tuple[np.ndarray, np.ndarray]]):
    xs = np.stack([s[0] for s in samples])
    ys = np.stack([s[1] for s in samples])
    return xs, ys


def eval_collate(samples: List[Tuple[np.ndarray, np.ndarray]]):
    """Concatenate sliding-window crops over the batch dim."""
    xs = np.concatenate([s[0] for s in samples], axis=0)
    ys = np.concatenate([s[1] for s in samples], axis=0)
    return xs, ys


def infer_collate(samples):
    """Stack the chips and carry their filenames and nodata masks."""
    xs = np.stack([s[0][0] for s in samples])
    files = [s[1] for s in samples]
    masks = np.stack([s[2] for s in samples])
    return xs, files, masks


def epoch_seed(seed: int, epoch: int) -> int:
    """A 63-bit seed for one epoch of a run seeded with ``seed``."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0] >> 1)


class EpochSampler(Sampler):
    """Yields (epoch, index) pairs: each pass over the dataset is the next
    epoch, shuffled (when ``shuffle``) by a ``torch.Generator`` seeded from
    (seed, epoch), so an epoch's order does not depend on earlier epochs.
    Set ``epoch`` to continue a resumed run."""

    def __init__(self, n: int, shuffle: bool, seed: int) -> None:
        self.n, self.shuffle, self.seed = n, shuffle, seed
        self.epoch = 0

    def __len__(self) -> int:
        return self.n

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        epoch = self.epoch
        self.epoch += 1
        if self.shuffle:
            g = torch.Generator().manual_seed(epoch_seed(self.seed, epoch))
            order = torch.randperm(self.n, generator=g).tolist()
        else:
            order = range(self.n)
        return iter([(epoch, i) for i in order])


def _to_tensors(batch, pin: bool = False) -> tuple:
    """A collated batch's numpy arrays as CPU tensors (pinned with ``pin``);
    other items (filenames) as they are."""
    out = []
    for a in batch:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
            if pin:
                a = a.pin_memory()
        out.append(a)
    return tuple(out)


class _ToTensors:
    """Collate wrapper: the batch as CPU tensors (``_to_tensors``)."""

    def __init__(self, collate_fn: Callable) -> None:
        self.collate_fn = collate_fn

    def __call__(self, samples):
        return _to_tensors(self.collate_fn(samples))


class _ArrayBatch:
    """A worker process's batch: the collate's items, arrays still numpy.
    torch's pin-memory thread calls ``pin_memory``, so the tensors are made
    and pinned off the consumer's thread; ``ProcessLoader`` makes them
    unpinned where nothing pins."""

    def __init__(self, items: tuple) -> None:
        self.items = items

    def pin_memory(self) -> tuple:
        return _to_tensors(self.items, pin=True)


class _ToArrays:
    """Collate wrapper of a worker process: the batch's arrays contiguous,
    still numpy (``_ArrayBatch``)."""

    def __init__(self, collate_fn: Callable) -> None:
        self.collate_fn = collate_fn

    def __call__(self, samples) -> _ArrayBatch:
        return _ArrayBatch(tuple(np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a
                                 for a in self.collate_fn(samples)))


class ProcessLoader(DataLoader):
    """A ``DataLoader`` of spawned worker processes that hand back numpy
    batches (``_ArrayBatch``); the tensors are made in this process, on
    torch's pin-memory thread where the loader pins.

    A worker that returns tensors moves them into shared memory from its
    queue's feeder thread, inside torch's C++ code. When the consumer drops
    an epoch early, the worker shuts down with that thread still sending,
    and the interpreter's exit aborts the process ("terminate called without
    an active exception"). numpy batches are pickled in Python and end
    cleanly."""

    def __iter__(self) -> Iterator:
        for batch in super().__iter__():
            yield _to_tensors(batch.items) if isinstance(batch, _ArrayBatch) else batch


class ThreadLoader:
    """Batches from ``num_workers`` threads in this process (the JAX
    package's ``worker_mode="thread"``): each epoch a producer thread maps
    the samples of a batch over a thread pool, collates them and puts the
    batch in a queue of at most ``prefetch_depth`` batches. The GeoTIFF
    decoders and numpy release the interpreter lock in their inner loops, so
    the workers overlap each other and the device. An exception in a worker
    is raised in the consumer; an iterator that is dropped before its end
    (the consumer raised or broke out) stops its producer."""

    def __init__(self, dataset, batch_size: int, sampler: "EpochSampler",
                 collate_fn: Callable, num_workers: int, prefetch_depth: int = 2,
                 pin_memory: bool = False, drop_last: bool = False) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.collate_fn = collate_fn
        self.num_workers = max(1, int(num_workers))
        self.prefetch_depth = max(1, int(prefetch_depth))
        self.pin_memory = pin_memory
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        keys = list(iter(self.sampler))  # the epoch advances here, as torch's does
        batches = [keys[i:i + self.batch_size] for i in range(0, len(keys), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return self._run(batches)

    def _run(self, batches: List[list]) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            """A bounded put that gives up once the consumer has gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                with ThreadPoolExecutor(self.num_workers,
                                        thread_name_prefix="instageo-loader-worker") as pool:
                    for keys in batches:
                        if stop.is_set():
                            return
                        batch = self.collate_fn(list(pool.map(self.dataset.__getitem__, keys)))
                        if self.pin_memory:
                            batch = tuple(a.pin_memory() if isinstance(a, torch.Tensor) else a
                                          for a in batch)
                        if not put(batch):
                            return
            except Exception as e:  # raised again in the consumer
                put(e)
            finally:
                put(end)

        threading.Thread(target=produce, name="instageo-loader", daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def create_dataloader(dataset, batch_size: int, shuffle: bool = False,
                      num_workers: int = 1, collate_fn: Callable = default_collate,
                      seed: int = 0, device=None, drop_last: bool = False,
                      worker_mode: str = "thread", prefetch_depth: int = 2):
    """A loader over ``dataset`` that yields the collate's arrays as CPU
    tensors, pinned when ``device`` is a CUDA device; ``len()`` is its
    batch count and ``.sampler.epoch`` the epoch its next pass draws.

    ``num_workers`` workers decode and augment, as ``worker_mode`` says:
    ``"thread"``, threads in this process with at most ``prefetch_depth``
    finished batches waiting (``ThreadLoader``); ``"process"``, spawned
    worker processes of a ``torch.utils.data.DataLoader``, kept across
    epochs, each keeping torch's default two batches ahead. With no workers
    the caller's thread decodes. Workers run numpy only and never touch
    CUDA. ``shuffle`` orders each epoch from a ``torch.Generator`` seeded
    from (seed, epoch), so every mode gives the same batches.
    """
    if worker_mode not in WORKER_MODES:
        raise ValueError(f"worker_mode must be one of {WORKER_MODES}, got {worker_mode!r}")
    workers = max(0, int(num_workers))
    pin = device is not None and torch.device(device).type == "cuda"
    sampler = EpochSampler(len(dataset), shuffle, seed)
    if workers > 0 and worker_mode == "thread":
        return ThreadLoader(dataset, batch_size, sampler, _ToTensors(collate_fn), workers,
                            prefetch_depth, pin_memory=pin, drop_last=drop_last)
    if workers > 0:
        return ProcessLoader(dataset, batch_size=batch_size, sampler=sampler,
                             num_workers=workers, collate_fn=_ToArrays(collate_fn),
                             pin_memory=pin, drop_last=drop_last, persistent_workers=True,
                             multiprocessing_context="spawn")
    return DataLoader(dataset, batch_size=batch_size, sampler=sampler,
                      collate_fn=_ToTensors(collate_fn), pin_memory=pin, drop_last=drop_last)
