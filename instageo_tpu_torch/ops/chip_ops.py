"""Device chip math: mask decode, chip extraction, seg-map stamping.

Counterpart of ``instageo_tpu/ops/chip_ops.py`` in torch, on the device of
the tensors it is given: gather a tile's chips in one indexed read, decode
QA masks (HLS Fmask bits, S2 SCL classes), apply the ``each``/``any``
masking strategy, stamp point labels into segmentation maps with
``(2w+1)²`` windows, and reduce chip and seg-map validity. Dtypes follow
the JAX package's: chips keep the tile's dtype (a float fill value makes
them float32), seg maps are int16 (float32 for regression), validity is
bool.

torch has few device ops for uint16, so a uint16 tile travels and stays
as its int16 bit pattern (``tile_to_device``: 2 bytes a pixel, not the 4 of
int32) and only the gathered chips are widened to int32
(``extract_chips_px(..., uint16=True)``); they go back to the host as
uint16.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from instageo_tpu_torch.device import resolve_device

# Fmask bit positions (HLS) and SCL classes (S2).
MASK_DECODING_POS = {
    "HLS": {"cloud": 1, "near_cloud_or_shadow": 2, "cloud_shadow": 3, "water": 5},
    "S2": {"cloud": [8, 9], "water": [6]},
}

SEG_MAP_NO_DATA = -1


def decode_fmask_value(mask: torch.Tensor, position: int) -> torch.Tensor:
    """Extract one QA bit: ``value // 2^pos mod 2`` (int32)."""
    return torch.div(mask.to(torch.int32), 2 ** position, rounding_mode="floor") % 2


def decode_scl_mask(mask: torch.Tensor, classes: Sequence[int]) -> torch.Tensor:
    """S2 SCL class membership (int32)."""
    m = mask.to(torch.int32)
    out = torch.zeros_like(m)
    for c in classes:
        out = out | (m == c).to(torch.int32)
    return out


def decode_mask(mask: torch.Tensor, pos) -> torch.Tensor:
    """Dispatch on the position spec: int -> bit decode, list -> class decode."""
    if isinstance(pos, (list, tuple)):
        return decode_scl_mask(mask, pos)
    return decode_fmask_value(mask, int(pos))


def tile_to_device(tile: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host tile on ``device`` in its own width; uint16 as its int16 bit
    pattern, which ``extract_chips_px(..., uint16=True)`` widens chip by
    chip."""
    tile = np.ascontiguousarray(tile)
    if tile.dtype == np.uint16:
        tile = tile.view(np.int16)
    return torch.from_numpy(tile).to(device)


def extract_chips_px(tile: torch.Tensor, offsets_px: Union[np.ndarray, torch.Tensor],
                     chip_size: int, uint16: bool = False) -> torch.Tensor:
    """Gather chips at pixel offsets: (B, H, W) + (N, 2) xy pixel starts ->
    (N, B, cs, cs), in one indexed read. A start past the tile's edge is
    clamped so the chip lies inside, as ``jax.lax.dynamic_slice`` does.
    ``uint16``: the tile holds uint16 bit patterns (``tile_to_device``); the
    chips come back widened to int32, contiguous."""
    if not isinstance(offsets_px, torch.Tensor):
        offsets_px = torch.from_numpy(np.asarray(offsets_px, np.int64))
    offsets = offsets_px.to(tile.device, torch.long).reshape(-1, 2)
    h, w = tile.shape[-2:]
    span = torch.arange(chip_size, device=tile.device)
    rows = offsets[:, 1].clamp(0, h - chip_size)[:, None] + span
    cols = offsets[:, 0].clamp(0, w - chip_size)[:, None] + span
    chips = tile[:, rows[:, :, None], cols[:, None, :]].transpose(0, 1)
    if uint16:
        chips = chips.to(torch.int32, memory_format=torch.contiguous_format)
        chips.bitwise_and_(0xFFFF)
    return chips


def extract_chips(tile: torch.Tensor, coords: Union[np.ndarray, torch.Tensor],
                  chip_size: int, uint16: bool = False) -> torch.Tensor:
    """Gather chips by chip-grid index: (B, H, W) + (N, 2) xy indices (col,
    row, as ``get_chip_coords`` gives them) -> (N, B, cs, cs)."""
    return extract_chips_px(tile, np.asarray(coords, np.int64) * chip_size, chip_size,
                            uint16)


def apply_mask(
    chips: torch.Tensor,
    masks: torch.Tensor,
    no_data_value: float,
    data_source: str = "HLS",
    mask_types: Sequence[str] = ("cloud",),
    masking_strategy: str = "each",
) -> torch.Tensor:
    """Mask chips with decoded QA values.

    chips: (N, T·C, cs, cs); masks: (N, T, cs, cs) raw QA values. ``each``
    repeats each timestep's mask over its bands; ``any`` collapses over
    time and masks every band.
    """
    n, tc, h, w = chips.shape
    t = masks.shape[1]
    out = chips
    for mask_type in mask_types:
        pos = MASK_DECODING_POS[data_source].get(mask_type)
        if pos is None:  # unknown types are skipped; bit position 0 is real
            continue
        decoded = decode_mask(masks, pos)  # (N, T, h, w)
        if masking_strategy == "each":
            m = decoded.repeat_interleave(tc // t, dim=1)
        elif masking_strategy == "any":
            m = decoded.any(dim=1, keepdim=True).expand(n, tc, h, w)
        else:
            raise ValueError(f"Invalid masking strategy: {masking_strategy}")
        out = torch.where(m == 0, out, no_data_value)
    return out


def stamp_segmentation(
    coords_rc: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    chip_size: int,
    window_size: int = 0,
    is_reg: bool = False,
) -> torch.Tensor:
    """Stamp labels at pixel (row, col) with a (2w+1)² window.

    coords_rc: (N, P, 2) chip-relative points of N chips (or (P, 2) for one
    chip); labels, valid: (N, P). Window cells are clipped to the chip;
    later points overwrite earlier ones; invalid (padded) points write
    nothing. Returns (N, cs, cs) (or (cs, cs)) int16, float32 if ``is_reg``.

    "Later wins" is made explicit and deterministic in two passes: a
    scatter-max of each point's 1-based order (0 for an invalid point, which
    then changes nothing) gives every cell its winning point, and the map is
    the winner's label gathered per cell. No index leaves the map, so
    nothing has to be dropped.
    """
    single = coords_rc.dim() == 2
    if single:
        coords_rc, labels, valid = coords_rc[None], labels[None], valid[None]
    dtype = torch.float32 if is_reg else torch.int16
    n, p = labels.shape
    dev = coords_rc.device
    offsets = torch.arange(-window_size, window_size + 1, device=dev)
    orow, ocol = torch.meshgrid(offsets, offsets, indexing="ij")
    rc = coords_rc.to(torch.long)
    rows = (rc[:, :, 0, None, None] + orow).clamp(0, chip_size - 1)
    cols = (rc[:, :, 1, None, None] + ocol).clamp(0, chip_size - 1)
    cells = chip_size * chip_size
    flat = (torch.arange(n, device=dev)[:, None, None, None] * cells
            + rows * chip_size + cols)
    prio = (torch.arange(p, device=dev, dtype=torch.int32) + 1)[None, :] * valid.to(torch.int32)
    prio = prio[:, :, None, None].expand(rows.shape)
    winner = torch.zeros(n * cells, dtype=torch.int32, device=dev)
    winner.scatter_reduce_(0, flat.reshape(-1), prio.reshape(-1), reduce="amax")
    winner = winner.view(n, cells)
    vals = labels.to(dtype)
    seg = torch.gather(vals, 1, (winner.to(torch.long) - 1).clamp_min(0))
    seg = torch.where(winner > 0, seg, SEG_MAP_NO_DATA).view(n, chip_size, chip_size)
    return seg[0] if single else seg


def mask_segmentation_map(
    chip: torch.Tensor,
    seg_map: torch.Tensor,
    chip_no_data_value: float,
    masking_strategy: str = "any",
) -> torch.Tensor:
    """Invalidate seg-map pixels without chip data: (…, C, h, w) chips,
    (…, h, w) maps. ``each``: a pixel is valid if ANY band has data;
    ``any``: only if ALL bands have data."""
    if masking_strategy == "each":
        valid = (chip != chip_no_data_value).any(dim=-3)
    elif masking_strategy == "any":
        valid = (chip != chip_no_data_value).all(dim=-3)
    else:
        raise ValueError(f"Invalid masking strategy: {masking_strategy}")
    return torch.where(valid, seg_map, SEG_MAP_NO_DATA)


def chip_has_data(chips: torch.Tensor, no_data_value: float) -> torch.Tensor:
    """Per chip: any pixel has data."""
    return (chips != no_data_value).flatten(1).any(dim=1)


def seg_has_labels(seg_maps: torch.Tensor) -> torch.Tensor:
    """Per chip: any labelled pixel."""
    return (seg_maps != SEG_MAP_NO_DATA).flatten(1).any(dim=1)


def _result_dtype(dtype: np.dtype, fill) -> np.dtype:
    """The dtype of ``where(cond, array of dtype, fill)``: an integer array
    stays integer under an int fill and becomes float32 under a float one,
    as both frameworks promote a Python scalar."""
    if np.issubdtype(dtype, np.floating) or not isinstance(fill, float):
        return np.dtype(dtype)
    return np.dtype(np.float32)


def process_tile_chips(
    tile: np.ndarray,
    mask_tile: Optional[np.ndarray],
    chip_coords: np.ndarray,
    point_rc: np.ndarray,
    point_labels: np.ndarray,
    point_chip_idx: np.ndarray,
    chip_size: int,
    no_data_value: float,
    data_source: str = "HLS",
    mask_types: Sequence[str] = (),
    masking_strategy: str = "each",
    window_size: int = 0,
    is_reg: bool = False,
    max_points_per_chip: int = 512,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Full tile -> (chips, seg_maps, chip_valid, seg_valid) as host arrays.

    The host groups the points per chip; extraction, masking, stamping and
    the validity reductions run on ``device`` (``cuda`` unless the caller
    asks for the CPU).

    Args:
        tile: (T·C, H, W) imagery; mask_tile: (T, H, W) QA or None.
        chip_coords: (N, 2) chip-grid xy indices.
        point_rc: (P, 2) tile-pixel (row, col) per observation.
        point_labels: (P,) labels; point_chip_idx: (P,) owning chip index.
    """
    dev = resolve_device(device)
    n = len(chip_coords)
    chip_coords = np.asarray(chip_coords)
    tile = np.asarray(tile)
    tile_t = tile_to_device(tile, dev)
    chips = extract_chips(tile_t, chip_coords, chip_size, tile.dtype == np.uint16)
    out_dtype = tile.dtype
    if mask_tile is not None and mask_types:
        mask_tile = np.asarray(mask_tile)
        masks = extract_chips(tile_to_device(mask_tile, dev), chip_coords, chip_size,
                              mask_tile.dtype == np.uint16)
        chips = apply_mask(chips, masks, no_data_value, data_source,
                           mask_types, masking_strategy)
        out_dtype = _result_dtype(out_dtype, no_data_value)
    del tile_t

    # Per-chip padded point tensors without a per-chip Python loop: one
    # stable argsort groups points by owning chip and keeps their order
    # within each chip, which "later points overwrite earlier" relies on.
    point_chip_idx = np.asarray(point_chip_idx)
    in_range = (point_chip_idx >= 0) & (point_chip_idx < n)
    sel = np.argsort(point_chip_idx[in_range], kind="stable")
    sorted_idx = np.nonzero(in_range)[0][sel]
    ci_sorted = point_chip_idx[sorted_idx]
    counts = np.bincount(ci_sorted, minlength=n)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(sorted_idx.size, dtype=np.int64) - starts[ci_sorted]

    # No observation is ever dropped, and one dense chip must not inflate
    # every chip's padding: chips with at most ``max_points_per_chip``
    # points share one bucket, denser chips get a power-of-two cap sized to
    # themselves, so the padded point arrays stay O(P).
    caps = np.full(n, max_points_per_chip, np.int64)
    dense = counts > max_points_per_chip
    if dense.any():
        caps[dense] = [1 << (int(c) - 1).bit_length() for c in counts[dense]]

    def stamp_bucket(ids: np.ndarray, cap: int) -> torch.Tensor:
        row_of = np.full(n, -1, np.int64)
        row_of[ids] = np.arange(len(ids))
        p_rc = np.zeros((len(ids), cap, 2), np.int32)
        p_lab = np.zeros((len(ids), cap), np.float32)
        p_valid = np.zeros((len(ids), cap), bool)
        m = row_of[ci_sorted] >= 0
        if m.any():
            bi, rk = row_of[ci_sorted[m]], rank[m]
            src = sorted_idx[m]
            x0 = chip_coords[ci_sorted[m], 0].astype(np.int64) * chip_size
            y0 = chip_coords[ci_sorted[m], 1].astype(np.int64) * chip_size
            p_rc[bi, rk, 0] = point_rc[src, 0] - y0
            p_rc[bi, rk, 1] = point_rc[src, 1] - x0
            p_lab[bi, rk] = point_labels[src]
            p_valid[bi, rk] = True
        return stamp_segmentation(
            torch.from_numpy(p_rc).to(dev), torch.from_numpy(p_lab).to(dev),
            torch.from_numpy(p_valid).to(dev), chip_size, window_size, is_reg)

    unique_caps = np.unique(caps)
    if len(unique_caps) == 1:
        seg_maps = stamp_bucket(np.arange(n), int(unique_caps[0]))
    else:
        seg_maps = torch.full((n, chip_size, chip_size), SEG_MAP_NO_DATA,
                              dtype=torch.float32 if is_reg else torch.int16, device=dev)
        for cap in unique_caps:
            ids = np.nonzero(caps == cap)[0]
            seg_maps[torch.from_numpy(ids).to(dev)] = stamp_bucket(ids, int(cap))
    seg_maps = mask_segmentation_map(chips, seg_maps, no_data_value, masking_strategy)

    chip_valid = chip_has_data(chips, no_data_value)
    seg_valid = seg_has_labels(seg_maps)
    chips_np = chips.cpu().numpy()
    if chips_np.dtype != out_dtype:  # a widened uint16 tile
        chips_np = chips_np.astype(out_dtype)
    return (chips_np, seg_maps.cpu().numpy(), chip_valid.cpu().numpy(),
            seg_valid.cpu().numpy())
