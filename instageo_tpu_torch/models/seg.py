"""Prithvi segmentation/regression model (encoder + upscaling head) in PyTorch.

Counterpart of ``instageo_tpu/models/seg.py:PrithviSeg`` with the reference
("torch") head: four upscaling stages (ConvTranspose2d ×2 → Dropout →
Conv2d(k, padding=1) → BatchNorm2d → ReLU) that halve the channel count, then
Dropout and a 1×1 conv to the class logits. Regression is the same network
with ``num_classes=1``. Submodule names follow the reference state dict
(``prithvi_encoder.*``, ``segmentation_head.{i}.{j}.*``).
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from instageo_tpu_torch.device import resolve_device
from instageo_tpu_torch.models.prithvi import PrithviViT, cast_matmul_weights
from instageo_tpu_torch.models.registry import (
    PRITHVI_ARCHS,
    SEG_HEAD_KERNEL_SIZES,
    get_arch,
)


class UpscalingBlock(nn.Sequential):
    """ConvT(k3, s2, p1, op1) → Dropout → Conv(k, p=1) → BN → ReLU.

    The padding stays 1 for every kernel size, so k=5/7 (the 600M variants)
    shrink the map, as in the reference. BatchNorm computes in float32; the
    block returns the convolutions' dtype.
    """

    def __init__(self, in_channels: int, out_channels: int, conv_kernel: int = 3,
                 dropout_rate: float = 0.1) -> None:
        super().__init__(
            nn.ConvTranspose2d(in_channels, out_channels, 3, stride=2, padding=1,
                               output_padding=1),
            nn.Dropout(dropout_rate),
            nn.Conv2d(out_channels, out_channels, conv_kernel, padding=1),
            nn.BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self[0].weight.dtype
        x = self[2](self[1](self[0](x.to(dtype))))
        return self[4](self[3](x.float())).to(dtype)


class PrithviSeg(nn.Module):
    """Segmentation head over the Prithvi encoder.

    ``forward`` takes (B, C, T, H, W) imagery and returns float32 logits,
    NCHW, or NHWC with ``channels_last``. With kernel sizes 3 the output
    matches the input resolution.
    """

    def __init__(
        self,
        variant: str = "prithvi_eo_v1_100",
        num_classes: int = 2,
        temporal_step: int = 1,
        image_size: int = 224,
        in_chans: int = 6,
        depth: int = -1,
        attn_impl: str = "kernel",
    ) -> None:
        super().__init__()
        arch = get_arch(variant, in_chans=in_chans, num_frames=temporal_step,
                        img_size=image_size, depth=depth)
        self.arch = arch
        self.temporal_step = temporal_step
        self.prithvi_encoder = PrithviViT(
            img_size=arch.img_size,
            patch_size=tuple(arch.patch_size),
            num_frames=arch.num_frames,
            in_chans=arch.in_chans,
            embed_dim=arch.embed_dim,
            depth=arch.depth,
            num_heads=arch.num_heads,
            mlp_ratio=arch.mlp_ratio,
            coords_encoding=tuple(arch.coords_encoding),
            attn_impl=attn_impl,
        )
        # embed_dims[i] = D·T / 2^i (reference model.py:380-383).
        embed_dims = [(arch.embed_dim * temporal_step) // (2**i) for i in range(5)]
        kernels = SEG_HEAD_KERNEL_SIZES[variant]
        self.segmentation_head = nn.Sequential(
            *(UpscalingBlock(embed_dims[i], embed_dims[i + 1], kernels[i])
              for i in range(4)),
            nn.Dropout(0.1),
            nn.Conv2d(embed_dims[4], num_classes, kernel_size=1),
        )

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype (that of the matmul weights)."""
        return self.segmentation_head[-1].weight.dtype

    def forward(self, img: torch.Tensor, return_features: bool = False,
                channels_last: bool = False):
        tokens = self.prithvi_encoder(img)
        feats = tokens[:, 1:, :]  # drop the cls token
        b, l, d = feats.shape
        t = self.temporal_step
        side = int((l // t) ** 0.5)
        # Tokens are ordered (t, h, w); channels are ordered c = d·T + t.
        x = feats.reshape(b, t, side, side, d).permute(0, 4, 1, 2, 3)
        x = x.reshape(b, d * t, side, side)
        feature_map = x
        x = x.to(self.dtype)
        head = self.segmentation_head
        for block in head[:-2]:
            x = block(x)
        logits = head[-1](head[-2](x)).float()
        if channels_last:
            logits = logits.permute(0, 2, 3, 1)
            feature_map = feature_map.permute(0, 2, 3, 1)
        if return_features:
            return logits, feature_map.float()
        return logits


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init from ``generator``, in place: torch's default
    U(±1/sqrt(fan_in)) for linear and conv weights and biases (fan_in from
    dim 1 on, as torch computes it, ConvTranspose2d included), unit/zero
    norms and BatchNorm statistics, N(0, 0.02) cls token."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)):
            w = module.weight
            bound = 1.0 / float(w.shape[1] * w[0, 0].numel()) ** 0.5
            w.uniform_(-bound, bound, generator=generator)
            if module.bias is not None:
                module.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(module, (nn.LayerNorm, nn.BatchNorm2d)):
            module.weight.fill_(1.0)
            module.bias.fill_(0.0)
            if isinstance(module, nn.BatchNorm2d):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
                module.num_batches_tracked.zero_()
        elif isinstance(module, PrithviViT):
            module.cls_token.normal_(0.0, 0.02, generator=generator)
    return model


def create_prithvi_seg(
    variant: str = "prithvi_eo_v1_100",
    *,
    num_classes: int = 2,
    temporal_step: int = 1,
    image_size: int = 224,
    num_bands: int = 6,
    depth: int = -1,
    dtype: torch.dtype = torch.float32,
    attn_impl: str = "kernel",
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
) -> PrithviSeg:
    """Build a ``PrithviSeg`` in eval mode on ``device`` (``cuda`` unless
    the caller asks for the CPU), randomly initialised from ``seed``, with
    its matmul weights in ``dtype``. Load trained weights with
    ``load_state_dict(..., strict=True)``."""
    if variant not in PRITHVI_ARCHS:
        raise KeyError(f"Unknown variant {variant!r}")
    dev = resolve_device(device)
    with torch.device("meta"):
        model = PrithviSeg(variant=variant, num_classes=num_classes,
                           temporal_step=temporal_step, image_size=image_size,
                           in_chans=num_bands, depth=depth, attn_impl=attn_impl)
    model.to_empty(device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(seed))
    return cast_matmul_weights(model, dtype).eval()
