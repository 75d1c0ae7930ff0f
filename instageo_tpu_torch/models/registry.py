"""Prithvi model-variant registry (the port's own copy).

The same variants and head kernel sizes as ``instageo_tpu/models/registry.py``
(a tiny test config, V1-100M, V2-300M and V2-600M, plus ``_tl``
temporal/location variants). Kept separate so the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence

# Band identity is a plain string enum-like set; order matters for patch-embed
# band surgery (reference: instageo/model/utils.py:40-58).
HLS_BANDS: List[str] = [
    "BLUE",
    "GREEN",
    "RED",
    "NIR_NARROW",
    "SWIR_1",
    "SWIR_2",
]
PRETRAINED_BANDS: List[str] = list(HLS_BANDS)


@dataclass(frozen=True)
class PrithviArch:
    """Architecture hyper-parameters of a Prithvi ViT encoder.

    Mirrors the fields of the reference ``PrithviConfig``
    (``instageo/model/model.py:39-102``); decoder fields are kept for config
    parity even though the ViT encoder (not the MAE decoder) is what the
    framework fine-tunes.
    """

    img_size: int = 224
    num_frames: int = 4
    patch_size: Sequence[int] = (1, 16, 16)
    in_chans: int = 6
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    decoder_embed_dim: int = 512
    decoder_depth: int = 8
    decoder_num_heads: int = 16
    mlp_ratio: float = 4.0
    coords_encoding: Sequence[str] = ()
    coords_scale_learn: bool = False
    bands: Sequence[str] = tuple(PRETRAINED_BANDS)
    mask_ratio: float = 0.75
    norm_pix_loss: bool = False

    def replace(self, **kwargs) -> "PrithviArch":
        """Return a copy with the given fields replaced."""
        return dataclasses.replace(self, **kwargs)

    @property
    def temporal_encoding(self) -> bool:
        return "time" in self.coords_encoding

    @property
    def location_encoding(self) -> bool:
        return "location" in self.coords_encoding


PRITHVI_ARCHS = {
    # Tiny config for tests/CI (reference: model.py:129-137).
    "prithvi_eo_tiny": PrithviArch(
        num_frames=1,
        embed_dim=256,
        depth=4,
        num_heads=4,
        decoder_embed_dim=128,
        decoder_depth=4,
        decoder_num_heads=4,
    ),
    "prithvi_eo_v1_100": PrithviArch(num_frames=3),
    "prithvi_eo_v2_100": PrithviArch(),
    "prithvi_eo_v2_300": PrithviArch(embed_dim=1024, depth=24, num_heads=16),
    "prithvi_eo_v2_300_tl": PrithviArch(
        embed_dim=1024,
        depth=24,
        num_heads=16,
        coords_encoding=("time", "location"),
        coords_scale_learn=True,
    ),
    "prithvi_eo_v2_600": PrithviArch(
        embed_dim=1280, depth=32, num_heads=16, patch_size=(1, 14, 14)
    ),
    "prithvi_eo_v2_600_tl": PrithviArch(
        embed_dim=1280,
        depth=32,
        num_heads=16,
        patch_size=(1, 14, 14),
        coords_encoding=("time", "location"),
        coords_scale_learn=True,
    ),
}

# Per-variant conv kernel sizes of the four decoder upscaling blocks
# (reference: model.py:169-177). Note the reference applies padding=1 for all
# kernel sizes, so k=5/7 shrink the spatial dims; we reproduce that behavior.
SEG_HEAD_KERNEL_SIZES = {
    "prithvi_eo_tiny": (3, 3, 3, 3),
    "prithvi_eo_v1_100": (3, 3, 3, 3),
    "prithvi_eo_v2_100": (3, 3, 3, 3),
    "prithvi_eo_v2_300": (3, 3, 3, 3),
    "prithvi_eo_v2_300_tl": (3, 3, 3, 3),
    "prithvi_eo_v2_600": (5, 5, 5, 7),
    "prithvi_eo_v2_600_tl": (5, 5, 5, 7),
}

def get_arch(
    variant: str,
    *,
    in_chans: int | None = None,
    num_frames: int | None = None,
    img_size: int | None = None,
    depth: int = -1,
    **overrides,
) -> PrithviArch:
    """Resolve a variant name to a concrete :class:`PrithviArch`.

    Mirrors the argument handling of the reference ``create_prithvi``
    (``instageo/model/model.py:180-219``): ``depth=-1`` keeps the variant's
    default depth; in_chans/num_frames/img_size override dataset-dependent
    fields.
    """
    if variant not in PRITHVI_ARCHS:
        raise KeyError(
            f"Unknown Prithvi variant {variant!r}; available: {sorted(PRITHVI_ARCHS)}"
        )
    arch = PRITHVI_ARCHS[variant]
    updates = dict(overrides)
    if depth != -1:
        updates["depth"] = depth
    if in_chans is not None:
        updates["in_chans"] = in_chans
    if num_frames is not None:
        updates["num_frames"] = num_frames
    if img_size is not None:
        updates["img_size"] = img_size
    return arch.replace(**updates) if updates else arch
