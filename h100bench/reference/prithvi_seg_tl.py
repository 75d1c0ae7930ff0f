"""Plain PyTorch reference of Prithvi-EO-2.0's TL segmentation model: the
encoder of ``prithvi_seg`` with the time and location embeddings of the
published TL encoders added to the patch tokens, and the same upscaling
head, preprocessing and float8 control.

The embeddings follow Prithvi-EO-2.0 (arXiv:2412.02732; the encoder card
ibm-nasa-geospatial/Prithvi-EO-2.0-600M-TL and its ``prithvi_mae.py``):
1D sincos of a value v over d dims is [sin(v·ω), cos(v·ω)] with
ω_i = 1/10000^(2i/d), i < d/2. The temporal embedding of a frame is the
sincos of its year over D/2 dims beside that of its day of year over the
other D/2, times the learned ``temporal_embed_enc.scale``, and is added to
each of the frame's tokens; the location embedding is the sincos of the
latitude over D/2 dims beside that of the longitude over D/2, times
``location_embed_enc.scale``, added to every patch token. Both go in after
the fixed 3D position embedding and before the cls token is prepended, so
the cls token gets neither.

Departures, each as the program runs it: the number of frames is the
chip's T (3), not the 4 of pretraining, so tokens per frame are the
patches of one frame; coords are taken for every chip (the published
model also runs without them, which adds nothing).

Everything runs in float32 (TF32 off); ``quant="fp8"`` holds in float8 what
the program holds in bf16, as in ``prithvi_seg``, the embeddings' sum with
the tokens included. Nothing here imports the program under test or JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100bench.reference import prithvi_seg as base
from h100bench.reference.prithvi_seg import (  # noqa: F401  (the harness calls them here)
    dropout_shapes,
    exact_float32,
    float32_exact,
    head,
    head_channels,
    preprocess,
    tokens,
)

SCALE_INIT = 0.1   # the TL encoders' learned scales at initialisation
SCALES = ("prithvi_encoder.temporal_embed_enc.scale",
          "prithvi_encoder.location_embed_enc.scale")


def param_spec(m: Dict) -> List[Tuple[str, Tuple[int, ...], Tuple]]:
    """``prithvi_seg.param_spec`` and the two scales, at their init."""
    return base.param_spec(m) + [(name, (1,), ("const", SCALE_INIT)) for name in SCALES]


def sincos(dim: int, values: torch.Tensor) -> torch.Tensor:
    """(N,) values -> (N, dim): [sin(v·ω), cos(v·ω)], ω_i = 1/10000^(2i/dim)."""
    omega = torch.arange(dim // 2, dtype=torch.float32, device=values.device) / (dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = values.reshape(-1).float()[:, None] * omega[None]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def temporal_embed(p: Dict[str, torch.Tensor], d: int, temporal_coords: torch.Tensor
                   ) -> torch.Tensor:
    """(B, T, 2) year and day of year -> (B, T, D)."""
    b, t, _ = temporal_coords.shape
    year = sincos(d // 2, temporal_coords[:, :, 0]).reshape(b, t, -1)
    day = sincos(d - d // 2, temporal_coords[:, :, 1]).reshape(b, t, -1)
    return p[SCALES[0]] * torch.cat([year, day], dim=-1)


def location_embed(p: Dict[str, torch.Tensor], d: int, location_coords: torch.Tensor
                   ) -> torch.Tensor:
    """(B, 2) latitude and longitude -> (B, 1, D)."""
    b = location_coords.shape[0]
    lat = sincos(d // 2, location_coords[:, 0]).reshape(b, 1, -1)
    lon = sincos(d - d // 2, location_coords[:, 1]).reshape(b, 1, -1)
    return p[SCALES[1]] * torch.cat([lat, lon], dim=-1)


def encoder(p: Dict[str, torch.Tensor], x: torch.Tensor, m: Dict,
            temporal_coords: Optional[torch.Tensor], location_coords: Optional[torch.Tensor],
            quant: Optional[str] = None, remat: bool = False) -> torch.Tensor:
    """(B, C, T, H, W) and the chips' coords -> (B, L, D) tokens after the
    final LayerNorm, the cls token first. A coord left out adds nothing."""
    enc = "prithvi_encoder"
    w = p[f"{enc}.patch_embed.proj.weight"]
    t = base._conv(F.conv3d, x, w, p[f"{enc}.patch_embed.proj.bias"], quant,
                   stride=tuple(m["patch_size"]))
    t = t.flatten(2).transpose(1, 2)                       # (B, L-1, D), t-major
    b, n, d = t.shape
    pe = base.pos_embed(m).to(x.device)
    t = t + pe[:, 1:]
    if temporal_coords is not None:
        frames = temporal_coords.shape[1]
        emb = temporal_embed(p, d, temporal_coords.to(x.device))
        t = (t.reshape(b, frames, n // frames, d) + emb[:, :, None]).reshape(b, n, d)
    if location_coords is not None:
        t = t + location_embed(p, d, location_coords.to(x.device))
    t = base._r(t, quant)
    cls = base._r(p[f"{enc}.cls_token"] + pe[:, :1], quant).expand(b, -1, -1)
    t = torch.cat([cls, t], dim=1)
    for i in range(m["depth"]):
        pre = f"{enc}.blocks.{i}"
        if remat and torch.is_grad_enabled():
            t = checkpoint(base._block, t, p, pre, m["num_heads"], quant, use_reentrant=False)
        else:
            t = base._block(t, p, pre, m["num_heads"], quant)
    return F.layer_norm(t, (d,), p[f"{enc}.norm.weight"], p[f"{enc}.norm.bias"], base.LN_EPS)


def logits(p, x, m, temporal_coords, location_coords, quant=None, **head_kw) -> torch.Tensor:
    tok = encoder(p, x, m, temporal_coords, location_coords, quant,
                  remat=head_kw.pop("remat", False))
    return head(p, tok, m, quant=quant, **head_kw)


@torch.no_grad()
def calibrate_bn(p: Dict[str, torch.Tensor], raw: torch.Tensor, m: Dict, pre: Dict,
                 temporal_coords: torch.Tensor, location_coords: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """``prithvi_seg.calibrate_bn`` with the chips' coords."""
    stats: list = []
    tok = encoder(p, preprocess(raw, pre), m, temporal_coords, location_coords)
    head(p, tok, m, batch_stats=True, stats_out=stats)
    out = {}
    for name, mean, var in stats:
        out[f"{name}.running_mean"] = mean
        out[f"{name}.running_var"] = var
    return out


@torch.no_grad()
def serve_logits(p, raw: torch.Tensor, m: Dict, pre: Dict, temporal_coords: torch.Tensor,
                 location_coords: torch.Tensor, quant=None, block: int = 16) -> torch.Tensor:
    """Eval-mode logits (B, classes, H, W) of raw chips and their coords,
    ``block`` chips at a time."""
    out = []
    for i in range(0, raw.shape[0], block):
        out.append(logits(p, preprocess(raw[i:i + block], pre), m,
                          temporal_coords[i:i + block], location_coords[i:i + block], quant))
    return torch.cat(out)


def flops_per_chip(m: Dict) -> float:
    """FLOPs of one chip's forward (matmuls and convolutions): the
    embeddings add none, so ``prithvi_seg``'s count."""
    return base.flops_per_chip(m)


def head_convs(m: Dict, batch: int) -> List[Tuple[float, float]]:
    """(FLOPs, bytes) of each head convolution of an eval-mode call over
    ``batch`` chips, in call order: the ConvTranspose2d and Conv2d of each
    of the four stages, then the 1x1 classifier. A multiply-add is 2 FLOPs,
    over every (output pixel, input channel, tap) of a convolution and every
    (input pixel, output channel, tap) of a transposed one; bytes: the
    input, weight, bias and output read or written once in bf16."""
    ch = head_channels(m)
    side = m["img_size"] // m["patch_size"][1]
    out = []

    def conv(pixels_in, pixels_out, cin, cout, taps, pixels_mac):
        out.append((2.0 * batch * pixels_mac * cin * cout * taps,
                    2.0 * (batch * (pixels_in * cin + pixels_out * cout)
                           + cin * cout * taps + cout)))

    for i, k in enumerate(m["head_kernels"]):
        up = 2 * side
        conv(side ** 2, up ** 2, ch[i], ch[i + 1], 9, side ** 2)     # ConvTranspose2d(k3, s2)
        side = up + 2 - k + 1                                        # Conv2d(k, padding 1)
        conv(up ** 2, side ** 2, ch[i + 1], ch[i + 1], k * k, side ** 2)
    conv(side ** 2, side ** 2, ch[4], m["num_classes"], 1, side ** 2)
    return out
