"""Model family: Prithvi ViT encoder + segmentation/regression heads."""

from instageo_tpu_torch.models.registry import (  # noqa: F401
    HLS_BANDS,
    PRETRAINED_BANDS,
    PRETRAINED_WEIGHTS,
    PRITHVI_ARCHS,
    SEG_HEAD_KERNEL_SIZES,
    PrithviArch,
    get_arch,
)

__all__ = [
    "HLS_BANDS",
    "PRETRAINED_BANDS",
    "PRETRAINED_WEIGHTS",
    "PRITHVI_ARCHS",
    "SEG_HEAD_KERNEL_SIZES",
    "PrithviArch",
    "get_arch",
]
