"""Prithvi segmentation/regression model (encoder + upscaling head) in PyTorch.

Counterpart of ``instageo_tpu/models/seg.py:PrithviSeg`` with both of its
heads (``HEADS``):

* ``"torch"``, the reference head: four upscaling stages (ConvTranspose2d
  ×2 → Dropout → Conv2d(k, padding=1) → BatchNorm2d → ReLU) that halve the
  channel count, then Dropout and a 1×1 conv to the class logits.
  Submodule names follow the reference state dict (``prithvi_encoder.*``,
  ``segmentation_head.{i}.{j}.*``);
* ``"fast"``, the JAX package's production head: three stages of 3×3
  convolutions with a 128-channel floor (``fast_up_{0,1,2}``), the head
  dropout and the 1×1 classifier (``fast_head_conv``) at half resolution,
  then a float32 bilinear resize of the logits to the input's H×W. Its
  names are the JAX scopes', so a checkpoint of the other head fails a
  strict load.

Regression is the same network with ``num_classes=1``.

Train mode follows the JAX model: the head's dropouts are ``Dropout``
(the fused kernel of ``ops/dropout.py`` by default), and BatchNorm updates
its running statistics as flax's ``nn.BatchNorm(momentum=0.9)`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from instageo_tpu_torch.device import resolve_device
from instageo_tpu_torch.models.prithvi import (
    LocationEncoder,
    PrithviViT,
    TemporalEncoder,
    cast_matmul_weights,
)
from instageo_tpu_torch.models.registry import (
    PRITHVI_ARCHS,
    SEG_HEAD_KERNEL_SIZES,
    get_arch,
)
from instageo_tpu_torch.ops.dropout import IMPLS as DROPOUT_IMPLS
from instageo_tpu_torch.ops.dropout import fused_dropout


def draw_seed(generator: torch.Generator) -> int:
    """A 63-bit seed from a CPU ``generator``: one draw per dropout call, and
    one per optimizer step from the epoch's stream."""
    return int(torch.randint(0, 2**63 - 1, (), generator=generator))


class SeedSlots:
    """The dropout seeds of a group of optimizer steps in device memory:
    ``buffer`` (int64) holds one seed per ``Dropout`` call, and each call
    takes the next slot, in the order the calls run. The trainer writes the
    seeds a step's own generator would give into the buffer before each
    group; a CUDA graph of the group reads them at every replay."""

    def __init__(self, n: int, device) -> None:
        self.buffer = torch.zeros(n, dtype=torch.int64, device=device)
        self.taken = 0

    def take(self) -> Tuple[torch.Tensor, int]:
        if self.taken >= self.buffer.numel():
            raise RuntimeError(f"more dropout calls than the {self.buffer.numel()} seed slots")
        self.taken += 1
        return self.buffer, self.taken - 1


class Dropout(nn.Module):
    """Dropout at rate ``p`` in train mode (counterpart of ``TPUDropout``).

    ``impl``: ``"kernel"`` (the Hopper kernel on a CUDA tensor, its plain
    version on a CPU tensor; the counterpart of ``"pallas"``) or ``"plain"``
    (the torch-op version everywhere; the counterpart of ``"xla"``). Each
    call draws its seed from ``generator``, a ``torch.Generator`` that
    ``set_dropout_generator`` hands out, or takes the next slot of
    ``seeds``, a ``SeedSlots`` that ``set_dropout_seeds`` hands out (the
    kernel then reads the seed from device memory); train mode with
    ``p > 0`` and neither raises. Eval mode and ``p == 0`` return the
    input; ``p >= 1`` returns zeros.
    """

    def __init__(self, p: float = 0.1, impl: str = "kernel") -> None:
        super().__init__()
        if impl not in DROPOUT_IMPLS:
            raise ValueError(f"dropout_impl={impl!r}; expected one of {DROPOUT_IMPLS}")
        self.p = p
        self.impl = impl
        self.generator: Optional[torch.Generator] = None
        self.seeds: Optional[SeedSlots] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        if self.seeds is not None:
            return fused_dropout(x, self.p, self.seeds.take(), self.impl)
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a torch.Generator: "
                               "call set_dropout_generator(model, generator)")
        return fused_dropout(x, self.p, draw_seed(self.generator), self.impl)

    def extra_repr(self) -> str:
        return f"p={self.p}, impl={self.impl!r}"


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over (B, H, W) in float32 with flax's train-mode statistics.

    Train mode normalises with the biased batch variance, as torch does, but
    updates ``running_var`` with it too (flax ``nn.BatchNorm(momentum=0.9)``:
    ``var ← 0.9·var + 0.1·biased var``), where torch would take the unbiased
    variance. Eval mode normalises with the running statistics. Returns
    float32.
    """

    def __init__(self, num_features: int, eps: float = 1e-5) -> None:
        super().__init__(num_features, eps=eps, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class UpscalingBlock(nn.Sequential):
    """ConvT(k3, s2, p1, op1) → Dropout → Conv(k, p=1) → BN → ReLU.

    The padding stays 1 for every kernel size, so k=5/7 (the 600M variants)
    shrink the map, as in the reference. The convolutions and the dropout run
    in the compute ``dtype`` (weights cast at use), BatchNorm in float32; the
    block returns ``dtype``.
    """

    def __init__(self, in_channels: int, out_channels: int, conv_kernel: int = 3,
                 dropout_rate: float = 0.1, dtype: torch.dtype = torch.float32,
                 dropout_impl: str = "kernel") -> None:
        super().__init__(
            nn.ConvTranspose2d(in_channels, out_channels, 3, stride=2, padding=1,
                               output_padding=1),
            Dropout(dropout_rate, dropout_impl),
            nn.Conv2d(out_channels, out_channels, conv_kernel, padding=1),
            BatchNorm2d(out_channels, eps=1e-5),
            nn.ReLU(),
        )
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        convt, conv = self[0], self[2]
        x = F.conv_transpose2d(x.to(dt), convt.weight.to(dt), convt.bias.to(dt),
                               stride=2, padding=1, output_padding=1)
        x = self[1](x)
        x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=conv.padding)
        return self[4](self[3](x)).to(dt)


HEADS = ("torch", "fast")


def fast_head_dims(base: int) -> Tuple[int, ...]:
    """Channels into and out of the fast head's three stages:
    ``[D·T] + [max(D·T / 2^(i+1), 128) for i in 0..2]``."""
    return (base,) + tuple(max(base // (2 ** (i + 1)), 128) for i in range(3))


def resize_logits(logits: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, C, h, w) logits -> (B, C, H, W) float32 by bilinear interpolation
    with half-pixel centres: ``jax.image.resize(..., "bilinear")`` when
    upsampling (its edge weights, renormalised, pick the edge pixel, as the
    clamp here does)."""
    return F.interpolate(logits.float(), size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=False)


class PrithviSeg(nn.Module):
    """Segmentation head over the Prithvi encoder.

    ``forward`` takes (B, C, T, H, W) imagery, and the ``_tl`` variants'
    optional coords, and returns float32 logits, NCHW, or NHWC with
    ``channels_last``. With kernel sizes 3 (and always with the fast head)
    the output matches the input resolution.
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
        dtype: torch.dtype = torch.float32,
        dropout_impl: str = "kernel",
        head_impl: str = "torch",
        gelu: str = "exact",
    ) -> None:
        super().__init__()
        if head_impl not in HEADS:
            raise ValueError(f"head_impl={head_impl!r}; expected one of {HEADS}")
        self.dtype = dtype
        self.head_impl = head_impl
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
            coords_scale_learn=arch.coords_scale_learn,
            attn_impl=attn_impl,
            dtype=dtype,
            gelu=gelu,
        )
        if head_impl == "fast":
            dims = fast_head_dims(arch.embed_dim * temporal_step)
            for i in range(3):
                setattr(self, f"fast_up_{i}", UpscalingBlock(
                    dims[i], dims[i + 1], 3, dtype=dtype, dropout_impl=dropout_impl))
            self.head_dropout = Dropout(0.1, dropout_impl)
            self.fast_head_conv = nn.Conv2d(dims[3], num_classes, kernel_size=1)
            return
        # embed_dims[i] = D·T / 2^i (reference model.py:380-383).
        embed_dims = [(arch.embed_dim * temporal_step) // (2**i) for i in range(5)]
        kernels = SEG_HEAD_KERNEL_SIZES[variant]
        self.segmentation_head = nn.Sequential(
            *(UpscalingBlock(embed_dims[i], embed_dims[i + 1], kernels[i], dtype=dtype,
                             dropout_impl=dropout_impl)
              for i in range(4)),
            Dropout(0.1, dropout_impl),
            nn.Conv2d(embed_dims[4], num_classes, kernel_size=1),
        )

    def forward(self, img: torch.Tensor, return_features: bool = False,
                channels_last: bool = False,
                temporal_coords: Optional[torch.Tensor] = None,
                location_coords: Optional[torch.Tensor] = None):
        tokens = self.prithvi_encoder(img, temporal_coords, location_coords)
        feats = tokens[:, 1:, :]  # drop the cls token
        b, l, d = feats.shape
        t = self.temporal_step
        side = int((l // t) ** 0.5)
        # Tokens are ordered (t, h, w); channels are ordered c = d·T + t.
        x = feats.reshape(b, t, side, side, d).permute(0, 4, 1, 2, 3)
        x = x.reshape(b, d * t, side, side)
        feature_map = x
        x = x.to(self.dtype)
        if self.head_impl == "fast":
            for i in range(3):
                x = getattr(self, f"fast_up_{i}")(x)
            dropout, conv = self.head_dropout, self.fast_head_conv
        else:
            head = self.segmentation_head
            for block in head[:-2]:
                x = block(x)
            dropout, conv = head[-2], head[-1]
        logits = F.conv2d(dropout(x), conv.weight.to(self.dtype),
                          conv.bias.to(self.dtype)).float()
        if self.head_impl == "fast":
            # The classifier ran at half resolution.
            logits = resize_logits(logits, img.shape[-2:])
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
    norms and BatchNorm statistics, N(0, 0.02) cls token, 0.1 for the
    ``_tl`` encoders' learnable scales."""
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
        elif isinstance(module, (TemporalEncoder, LocationEncoder)) and module.scale is not None:
            module.scale.fill_(0.1)
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
    param_dtype: Optional[torch.dtype] = None,
    attn_impl: str = "kernel",
    dropout_impl: str = "kernel",
    head_impl: str = "torch",
    gelu: str = "exact",
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
) -> PrithviSeg:
    """Build a ``PrithviSeg`` in eval mode on ``device`` (``cuda`` unless
    the caller asks for the CPU), randomly initialised from ``seed``.

    ``dtype`` is the compute dtype. ``param_dtype`` is the dtype the matmul
    weights are stored in: ``dtype`` by default (serving), float32 for
    training, as the JAX model keeps float32 params; norms, BatchNorm and
    the cls token are float32 either way. Load trained weights with
    ``load_state_dict(..., strict=True)``; ``train_mode`` readies the model
    for training."""
    if variant not in PRITHVI_ARCHS:
        raise KeyError(f"Unknown variant {variant!r}")
    dev = resolve_device(device)
    with torch.device("meta"):
        model = PrithviSeg(variant=variant, num_classes=num_classes,
                           temporal_step=temporal_step, image_size=image_size,
                           in_chans=num_bands, depth=depth, attn_impl=attn_impl,
                           dtype=dtype, dropout_impl=dropout_impl, head_impl=head_impl,
                           gelu=gelu)
    model.to_empty(device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(seed))
    return cast_matmul_weights(model, param_dtype or dtype).eval()


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]
                          ) -> nn.Module:
    """Every ``Dropout`` of ``model`` draws its seeds from ``generator``."""
    for module in model.modules():
        if isinstance(module, Dropout):
            module.generator, module.seeds = generator, None
    return model


def set_dropout_seeds(model: nn.Module, seeds: SeedSlots) -> nn.Module:
    """Every ``Dropout`` of ``model`` takes its seeds from the slots of
    ``seeds``, in call order."""
    for module in model.modules():
        if isinstance(module, Dropout):
            module.generator, module.seeds = None, seeds
    return model


def train_mode(model: nn.Module, generator: torch.Generator,
               dropout_rate: Optional[float] = None) -> nn.Module:
    """Put ``model`` in train mode: BatchNorm on batch statistics with
    flax's running-statistics update (``BatchNorm2d``), every ``Dropout``
    drawing its seeds from ``generator``, and optionally another dropout
    rate."""
    if dropout_rate is not None:
        for module in model.modules():
            if isinstance(module, Dropout):
                module.p = dropout_rate
    set_dropout_generator(model, generator)
    return model.train()
