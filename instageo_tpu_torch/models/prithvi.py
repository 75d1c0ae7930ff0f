"""Prithvi geospatial ViT encoder in PyTorch.

Counterpart of ``instageo_tpu/models/prithvi.py`` (``PrithviViT``, with the
temporal and location encoders of the ``_tl`` variants). Module and
parameter names follow the reference timm layout (``patch_embed.proj``,
``blocks.{i}.attn.qkv``, ``temporal_embed_enc.scale``, ...), so a converted
state dict loads with ``strict=True``. The JAX ``"scan"`` block layout
stacks the same blocks' parameters; here every layout builds the same
modules (the weight bridge unstacks a stacked tree).

Compute types follow the JAX ``dtype`` field: matmuls in the compute dtype
``dtype`` (bf16 in serving and training), LayerNorm statistics and output in
float32 (the caller casts), softmax statistics in float32, GELU as
``gelu`` says (``GELUS``), the residual stream in the compute dtype. The compute dtype is separate from the
parameters' dtype, as the JAX model's ``param_dtype=float32`` is: weights are
cast to ``dtype`` where they are used, and the cast is differentiable, so
float32 parameters get float32 gradients. Serving may store the matmul
weights in the compute dtype (``cast_matmul_weights``); the cast is then a
no-op.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from instageo_tpu_torch.ops.attention import IMPLS as ATTN_IMPLS
from instageo_tpu_torch.ops.attention import flash_attention_blo

# ---------------------------------------------------------------------------
# Sincos positional embeddings (numpy; static per model config)
# ---------------------------------------------------------------------------


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """1D sincos embedding: ``[sin(pos ⊗ ω), cos(pos ⊗ ω)]``, ``ω_d = 1/10000^(2d/D)``."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float32)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = np.asarray(pos, dtype=np.float32).reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_3d_sincos_pos_embed(
    embed_dim: int,
    grid_size: Tuple[int, int, int],
    cls_token: bool = False,
) -> np.ndarray:
    """3D sincos embedding over a (t, h, w) grid.

    The embedding dim splits 4:6:6 (t:h:w) in units of ``embed_dim // 16``
    and concatenates in (w, h, t) order; tokens are laid out t-major, then h,
    then w. A zero row leads when ``cls_token``.
    """
    assert embed_dim % 16 == 0
    t_size, h_size, w_size = grid_size

    w_embed_dim = embed_dim // 16 * 6
    h_embed_dim = embed_dim // 16 * 6
    t_embed_dim = embed_dim // 16 * 4

    w_pos = get_1d_sincos_pos_embed_from_grid(w_embed_dim, np.arange(w_size))
    h_pos = get_1d_sincos_pos_embed_from_grid(h_embed_dim, np.arange(h_size))
    t_pos = get_1d_sincos_pos_embed_from_grid(t_embed_dim, np.arange(t_size))

    w_pos = np.tile(w_pos, (t_size * h_size, 1))
    h_pos = np.tile(np.repeat(h_pos, w_size, axis=0), (t_size, 1))
    t_pos = np.repeat(t_pos, h_size * w_size, axis=0)

    pos_embed = np.concatenate((w_pos, h_pos, t_pos), axis=1)
    if cls_token:
        pos_embed = np.concatenate([np.zeros([1, embed_dim]), pos_embed], axis=0)
    return pos_embed.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _cached_pos_embed(embed_dim: int, grid_size: Tuple[int, int, int]) -> np.ndarray:
    return get_3d_sincos_pos_embed(embed_dim, grid_size, cls_token=True)[None]


def interpolate_pos_encoding(
    embed_dim: int,
    grid_size: Tuple[int, int, int],
    patch_size: Sequence[int],
    sample_shape: Tuple[int, int, int],
) -> torch.Tensor:
    """(1, 1 + L, D) float32 positional encoding for an input of
    ``sample_shape`` = (T, H, W) frames and pixels.

    Re-generates the sincos field when the number of frames changes and
    resizes it bicubically (align_corners) when the spatial grid changes.
    """
    t, h, w = sample_shape
    t_patches = t // patch_size[0]
    h_patches = h // patch_size[1]
    w_patches = w // patch_size[2]

    if (t_patches, h_patches, w_patches) == tuple(grid_size):
        return torch.from_numpy(_cached_pos_embed(embed_dim, tuple(grid_size)))

    new_grid = (t_patches, grid_size[1], grid_size[2])
    pos = torch.from_numpy(_cached_pos_embed(embed_dim, new_grid))
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    # (t, h, w, D) -> (t, D, h, w): resize the trailing spatial dims.
    patch_pos = patch_pos.reshape(*new_grid, embed_dim).permute(0, 3, 1, 2)
    patch_pos = F.interpolate(patch_pos, size=(h_patches, w_patches),
                              mode="bicubic", align_corners=True)
    patch_pos = patch_pos.permute(0, 2, 3, 1).reshape(1, -1, embed_dim)
    return torch.cat([cls_pos, patch_pos], dim=1)


def _sincos_from_values(embed_dim: int, values: torch.Tensor) -> torch.Tensor:
    """1D sincos embedding of runtime values, float32: (N,) -> (N, embed_dim)."""
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=values.device)
    omega = 1.0 / 10000 ** (omega / (embed_dim / 2.0))
    out = values.reshape(-1).float()[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

GELUS = ("exact", "tanh", "bf16")


_MATMUL_LAYERS = (nn.Linear, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d)


def cast_matmul_weights(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store the weights of every linear and convolution layer in the compute
    ``dtype``; norms and the cls token stay float32, as the JAX ``dtype``
    field leaves its float32 params for everything but the matmuls."""
    for module in model.modules():
        if isinstance(module, _MATMUL_LAYERS):
            module.to(dtype)
    return model


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in the compute ``dtype`` (input, weight and bias
    cast to it)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), _cast(layer.bias, dtype))


class PatchEmbed3D(nn.Module):
    """3D patch embedding: a Conv3d with kernel == stride, run as reshape +
    one matmul over per-patch vectors ordered ``(c, pt, ph, pw)`` (the Conv3d
    weight's contraction order). Tokens come out t-major, then h, then w."""

    def __init__(self, patch_size: Tuple[int, int, int], in_chans: int,
                 embed_dim: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.patch_size = tuple(patch_size)
        self.proj = nn.Conv3d(in_chans, embed_dim, kernel_size=self.patch_size,
                              stride=self.patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, T, H, W) -> tokens (B, L, D) in the compute dtype."""
        b, c, t, h, w = x.shape
        pt, ph, pw = self.patch_size
        # The border that does not fill a patch is ignored.
        x = x[:, :, : (t // pt) * pt, : (h // ph) * ph, : (w // pw) * pw]
        gt, gh, gw = t // pt, h // ph, w // pw
        x = x.reshape(b, c, gt, pt, gh, ph, gw, pw)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
        x = x.reshape(b, gt * gh * gw, c * pt * ph * pw)
        weight = self.proj.weight.to(self.dtype)
        return F.linear(x.to(self.dtype), weight.reshape(weight.shape[0], -1),
                        _cast(self.proj.bias, self.dtype))


class LayerNormF32(nn.LayerNorm):
    """LayerNorm computed in float32, returning float32 (eps 1e-5)."""

    def __init__(self, dim: int) -> None:
        super().__init__(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps)


class Attention(nn.Module):
    """Multi-head self-attention: fused ``qkv`` Linear(D, 3D) with output
    columns ordered (3, H, Dh), the fused attention op, then ``proj``.

    ``attn_impl``: ``"kernel"`` runs ``flash_attention_blo`` through the
    Hopper forward and backward kernels on a CUDA tensor (their plain
    versions on a CPU tensor); ``"plain"`` runs the same autograd Function
    on the plain versions everywhere.
    """

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "kernel",
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}; expected one of {ATTN_IMPLS}")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        h = self.num_heads
        qkv = _linear(x, self.qkv, self.dtype).view(b, l, 3, h, d // h)
        # Heads-first views of the projection output; no copies.
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = flash_attention_blo(q, k, v, self.attn_impl)
        return _linear(out, self.proj, self.dtype)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2. ``gelu`` is the JAX ``tpu.gelu`` lowering:
    ``exact`` (erf in float32, timm's), ``tanh`` (the tanh approximation in
    float32) or ``bf16`` (erf in the compute dtype, no float32 round trip);
    the result is in the compute dtype either way."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32, gelu: str = "exact") -> None:
        super().__init__()
        if gelu not in GELUS:
            raise ValueError(f"gelu={gelu!r}; expected one of {GELUS}")
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.dtype = dtype
        self.gelu = gelu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _linear(x, self.fc1, self.dtype)
        if self.gelu == "bf16":
            y = F.gelu(y)
        else:
            approximate = "tanh" if self.gelu == "tanh" else "none"
            y = F.gelu(y.float(), approximate=approximate).to(y.dtype)
        return _linear(y, self.fc2, self.dtype)


class Block(nn.Module):
    """Pre-LN transformer block: x + Attn(LN(x)); x + MLP(LN(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_impl: str = "kernel", dtype: torch.dtype = torch.float32,
                 gelu: str = "exact") -> None:
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn = Attention(dim, num_heads, attn_impl, dtype)
        self.norm2 = LayerNormF32(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, gelu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x).to(x.dtype))
        return x + self.mlp(self.norm2(x).to(x.dtype))


class TemporalEncoder(nn.Module):
    """Year and day-of-year sincos encoding of (B, T, 2) ``temporal_coords``
    (reference pritvhi.py:273-322): half the dims each, times ``scale``
    (learnable, 0.1 at init, with ``trainable_scale``; else 1), float32."""

    def __init__(self, embed_dim: int, trainable_scale: bool = False) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.scale = nn.Parameter(torch.full((1,), 0.1)) if trainable_scale else None

    def forward(self, temporal_coords: torch.Tensor,
                tokens_per_frame: Optional[int] = None) -> torch.Tensor:
        b, t, _ = temporal_coords.shape
        year_dim = self.embed_dim // 2
        year = _sincos_from_values(year_dim, temporal_coords[:, :, 0]).reshape(b, t, -1)
        jday = _sincos_from_values(self.embed_dim - year_dim,
                                  temporal_coords[:, :, 1]).reshape(b, t, -1)
        emb = torch.cat([year, jday], dim=-1)
        if self.scale is not None:
            emb = self.scale * emb
        if tokens_per_frame is not None:
            emb = emb.repeat_interleave(tokens_per_frame, dim=1)
        return emb


class LocationEncoder(nn.Module):
    """Latitude and longitude sincos encoding of (B, 2) ``location_coords``
    (reference pritvhi.py:325-367), (B, 1, D) float32, scaled as
    ``TemporalEncoder``."""

    def __init__(self, embed_dim: int, trainable_scale: bool = False) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.scale = nn.Parameter(torch.full((1,), 0.1)) if trainable_scale else None

    def forward(self, location_coords: torch.Tensor) -> torch.Tensor:
        b = location_coords.shape[0]
        lat_dim = self.embed_dim // 2
        lat = _sincos_from_values(lat_dim, location_coords[:, 0]).reshape(b, 1, -1)
        lon = _sincos_from_values(self.embed_dim - lat_dim,
                                 location_coords[:, 1]).reshape(b, 1, -1)
        emb = torch.cat([lat, lon], dim=-1)
        return emb if self.scale is None else self.scale * emb


class PrithviViT(nn.Module):
    """Prithvi ViT encoder.

    Input (B, C, T, H, W), or (B, C, H, W) when the temporal patch is 1;
    output (B, 1 + T·h·w, D) float32 tokens, the cls token first. The
    residual stream runs in the compute ``dtype``. The ``_tl`` variants'
    encoders (``coords_encoding``) are built, and, as in the reference
    forward, add their embeddings only when coords are passed: the
    temporal one per frame, the location one to every patch token; each in
    float32, then cast to the token dtype.
    """

    def __init__(
        self,
        img_size: int = 224,
        patch_size: Tuple[int, int, int] = (1, 16, 16),
        num_frames: int = 1,
        in_chans: int = 3,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        coords_encoding: Sequence[str] = (),
        coords_scale_learn: bool = False,
        attn_impl: str = "kernel",
        dtype: torch.dtype = torch.float32,
        gelu: str = "exact",
    ) -> None:
        super().__init__()
        self.img_size = img_size
        self.patch_size = tuple(patch_size)
        self.num_frames = num_frames
        self.embed_dim = embed_dim
        self.patch_embed = PatchEmbed3D(self.patch_size, in_chans, embed_dim, dtype)
        if "time" in coords_encoding:
            self.temporal_embed_enc = TemporalEncoder(embed_dim, coords_scale_learn)
        if "location" in coords_encoding:
            self.location_embed_enc = LocationEncoder(embed_dim, coords_scale_learn)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, attn_impl, dtype, gelu)
            for _ in range(depth))
        self.norm = LayerNormF32(embed_dim)
        self._pos_cache: Dict[tuple, torch.Tensor] = {}

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        return (
            self.num_frames // self.patch_size[0],
            self.img_size // self.patch_size[1],
            self.img_size // self.patch_size[2],
        )

    def _pos_embed(self, sample_shape, device) -> torch.Tensor:
        key = (tuple(sample_shape), str(device))
        pos = self._pos_cache.get(key)
        if pos is None:
            pos = interpolate_pos_encoding(self.embed_dim, self.grid_size,
                                           self.patch_size, tuple(sample_shape))
            pos = pos.to(device)
            self._pos_cache[key] = pos
        return pos

    def forward(self, x: torch.Tensor, temporal_coords: Optional[torch.Tensor] = None,
                location_coords: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.dim() == 4 and self.patch_size[0] == 1:
            x = x[:, :, None]
        tokens = self.patch_embed(x)
        pos = self._pos_embed(x.shape[-3:], tokens.device)
        tokens = tokens + pos[:, 1:].to(tokens.dtype)
        if temporal_coords is not None and hasattr(self, "temporal_embed_enc"):
            temporal_coords = temporal_coords.to(tokens.device)
            per_frame = tokens.shape[1] // temporal_coords.shape[1]
            tokens = tokens + self.temporal_embed_enc(temporal_coords,
                                                      per_frame).to(tokens.dtype)
        if location_coords is not None and hasattr(self, "location_embed_enc"):
            tokens = tokens + self.location_embed_enc(
                location_coords.to(tokens.device)).to(tokens.dtype)
        cls = (self.cls_token + pos[:, :1]).to(tokens.dtype)
        tokens = torch.cat([cls.expand(tokens.shape[0], -1, -1), tokens], dim=1)
        for block in self.blocks:
            tokens = block(tokens)
        return self.norm(tokens)
