"""Prithvi geospatial ViT encoder in PyTorch.

Counterpart of ``instageo_tpu/models/prithvi.py`` (``PrithviViT``, with the
temporal and location encoders of the ``_tl`` variants). Module and
parameter names follow the reference timm layout (``patch_embed.proj``,
``blocks.{i}.attn.qkv``, ``temporal_embed_enc.scale``, ...), so a converted
state dict loads with ``strict=True``. The JAX ``"scan"`` block layout
stacks the same blocks' parameters; here every layout builds the same
modules (the weight bridge unstacks a stacked tree).

Compute types follow the JAX ``dtype`` field: matmuls in the compute dtype
``dtype`` (bf16 in serving and training), LayerNorm statistics and affine
in float32 (the blocks' norms rounded once to the compute dtype, the final
norm's output float32), softmax statistics in float32, GELU as ``gelu``
says (``GELUS``), the residual stream in the compute dtype. On a card, the
blocks' bf16 LayerNorms run ``ops/norm_act.py``'s kernels, and their exact
GELUs PyTorch's bf16 GELU; both compute in float32 and round where the
float32 round trip does. The
compute dtype is separate from the parameters' dtype, as the JAX model's
``param_dtype=float32`` is: weights are cast to ``dtype`` where they are
used, and the cast is differentiable, so float32 parameters get float32
gradients. Serving may store the matmul
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
from torch.utils.checkpoint import checkpoint

from instageo_tpu_torch.models.checkpoint import (  # noqa: F401  (JAX's names)
    stack_block_params,
    unstack_block_params,
)
from instageo_tpu_torch.ops import norm_act
from instageo_tpu_torch.ops._build import HostCounter
from instageo_tpu_torch.ops.attention import IMPLS as KERNEL_IMPLS
from instageo_tpu_torch.ops.attention import flash_attention_blo
from instageo_tpu_torch.ops.quant import QUANTS, QuantLinear
from instageo_tpu_torch.utils.telemetry import span

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
# "kernel" and "plain" run ``FlashAttention``; "xla" runs ``xla_attention``.
ATTN_IMPLS = KERNEL_IMPLS + ("xla",)
xla_attn_calls = HostCounter()  # Attention forwards on the "xla" route
coord_embeds = HostCounter()    # forwards that added a ``_tl`` coords embedding
coords_missing = HostCounter()  # ``_tl`` forwards with an encoder's coords not given


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


def _linear(x: torch.Tensor, layer: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in the compute ``dtype`` (input, weight and bias
    cast to it); a ``QuantLinear`` runs its int8 product and returns
    ``dtype``."""
    if isinstance(layer, QuantLinear):
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype), _cast(layer.bias, dtype))


def _dense(dim_in: int, dim_out: int, quant: str, dtype: torch.dtype) -> nn.Module:
    if quant not in QUANTS:
        raise ValueError(f"quant={quant!r}; expected one of {QUANTS}")
    return QuantLinear(dim_in, dim_out, dtype) if quant == "int8" else nn.Linear(dim_in, dim_out)


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The attention chain the JAX model leaves to XLA
    (``instageo_tpu/models/prithvi.py:Attention``, ``attn_impl="xla"``), in
    q's dtype: scores of ``q * scale`` and k, softmax in float32 cast back,
    then the product with v. q/k/v (B, H, L, Dh) -> (B, L, H·Dh)."""
    b, h, l, d = q.shape
    scores = torch.matmul(q * d ** -0.5, k.transpose(-1, -2))
    attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(attn, v).transpose(1, 2).reshape(b, l, h * d)


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
    """LayerNorm computed in float32, returning float32 (eps 1e-5);
    ``rounded`` returns it rounded once to the input's dtype."""

    def __init__(self, dim: int) -> None:
        super().__init__(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps)

    def rounded(self, x: torch.Tensor) -> torch.Tensor:
        """``forward(x)`` rounded to x's dtype: one kernel pass for a bf16
        tensor on a card (``norm_act.layer_norm``)."""
        return norm_act.layer_norm(x, self.weight, self.bias, self.eps)


class Attention(nn.Module):
    """Multi-head self-attention: fused ``qkv`` Linear(D, 3D) with output
    columns ordered (3, H, Dh), the fused attention op, then ``proj``.

    ``attn_impl``: ``"kernel"`` runs ``flash_attention_blo`` through the
    Hopper forward and backward kernels on a CUDA tensor (their plain
    versions on a CPU tensor); ``"plain"`` runs the same autograd Function
    on the plain versions everywhere; ``"xla"`` runs ``xla_attention``, the
    chain the JAX model runs outside its kernel (the route of a float32
    model, whose dtype the bf16 kernels do not take).

    ``quant="int8"``: ``qkv`` and ``proj`` are ``QuantLinear``. Quantizing
    the fused (3D, D) weight per output row is the JAX model's per-slice
    q/k/v quantization, since the output columns are independent.
    """

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "kernel",
                 dtype: torch.dtype = torch.float32, quant: str = "none") -> None:
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}; expected one of {ATTN_IMPLS}")
        self.num_heads = self.num_heads_local = num_heads
        self.head_dim = dim // num_heads
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.qkv = _dense(dim, 3 * dim, quant, dtype)
        self.proj = _dense(dim, dim, quant, dtype)
        self.tp_group = None  # the ``model`` group under tensor parallelism

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """``qkv`` and the attention of this rank's heads (all of them
        without tensor parallelism): (B, L, heads·Dh)."""
        b, l, _ = x.shape
        qkv = _linear(x, self.qkv, self.dtype).view(b, l, 3, self.num_heads_local,
                                                    self.head_dim)
        # Heads-first views of the projection output; no copies.
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        if self.attn_impl == "xla":
            xla_attn_calls.add()
            return xla_attention(q, k, v)
        return flash_attention_blo(q, k, v, self.attn_impl)

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor-parallel product of this rank's heads: its columns of
        ``proj`` without the bias; the sum over the ``model`` group is the
        output."""
        return F.linear(self._heads(x), self.proj.weight.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is not None:
            from instageo_tpu_torch.parallel.tp import copy_to_model, reduce_from_model

            out = reduce_from_model(self.partial(copy_to_model(x, self.tp_group)),
                                    self.tp_group)
            return out + self.proj.bias.to(self.dtype)
        return _linear(self._heads(x), self.proj, self.dtype)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2. ``gelu`` is the JAX ``tpu.gelu`` lowering:
    ``exact`` (erf in float32, timm's; on a card the same bits as ``bf16``),
    ``tanh`` (the tanh approximation in
    float32) or ``bf16`` (erf in the compute dtype, no float32 round trip);
    the result is in the compute dtype either way. ``quant="int8"``: both
    layers are ``QuantLinear``."""

    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32, gelu: str = "exact",
                 quant: str = "none") -> None:
        super().__init__()
        if gelu not in GELUS:
            raise ValueError(f"gelu={gelu!r}; expected one of {GELUS}")
        self.fc1 = _dense(dim, hidden_dim, quant, dtype)
        self.fc2 = _dense(hidden_dim, dim, quant, dtype)
        self.dtype = dtype
        self.gelu = gelu
        self.tp_group = None  # the ``model`` group under tensor parallelism

    def _hidden(self, x: torch.Tensor) -> torch.Tensor:
        y = _linear(x, self.fc1, self.dtype)
        if self.gelu == "bf16" or (self.gelu == "exact" and y.is_cuda):
            # CUDA's GELU computes in float32 and rounds once: on a card,
            # ``exact`` is the float32 round trip's bits without its casts.
            return F.gelu(y)
        approximate = "tanh" if self.gelu == "tanh" else "none"
        return F.gelu(y.float(), approximate=approximate).to(y.dtype)

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor-parallel product of this rank's ``fc1`` rows and ``fc2``
        columns, without ``fc2``'s bias; the sum over the group is the
        output."""
        return F.linear(self._hidden(x), self.fc2.weight.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is not None:
            from instageo_tpu_torch.parallel.tp import copy_to_model, reduce_from_model

            out = reduce_from_model(self.partial(copy_to_model(x, self.tp_group)),
                                    self.tp_group)
            return out + self.fc2.bias.to(self.dtype)
        return _linear(self._hidden(x), self.fc2, self.dtype)


class Block(nn.Module):
    """Pre-LN transformer block: x + Attn(LN(x)); x + MLP(LN(x)).

    ``remat``: in training, the block's activations are recomputed in the
    backward (``torch.utils.checkpoint``, one checkpoint per block, the
    JAX package's ``nn.remat(Block)``), so the attention forward runs twice
    per step. ``set_tensor_parallel`` makes the attention and the MLP
    tensor-parallel over a ``model`` group (``parallel/tp.py``) and, with
    ``sp``, takes and returns this rank's token shard of the residual
    stream (padded to the group) instead of the whole stream.
    """

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 attn_impl: str = "kernel", dtype: torch.dtype = torch.float32,
                 gelu: str = "exact", quant: str = "none", remat: bool = False) -> None:
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn = Attention(dim, num_heads, attn_impl, dtype, quant)
        self.norm2 = LayerNormF32(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, gelu, quant)
        self.remat = remat
        self.sp_group = None
        self.length = 0  # tokens of the unpadded stream under ``sp``

    def set_tensor_parallel(self, group, heads_local: int, sp: bool = False) -> None:
        self.attn.tp_group = self.mlp.tp_group = None if sp else group
        self.attn.num_heads_local = heads_local
        self.sp_group = group if sp else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._forward, x, use_reentrant=False)
        return self._forward(x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.sp_group is not None:
            return self._forward_sp(x)
        x = x + self.attn(self.norm1.rounded(x))
        return x + self.mlp(self.norm2.rounded(x))

    def _forward_sp(self, x: torch.Tensor) -> torch.Tensor:
        from instageo_tpu_torch.parallel.tp import gather_tokens, scatter_tokens

        g, dt = self.sp_group, x.dtype
        y = gather_tokens(self.norm1.rounded(x), g, self.length)
        x = x + scatter_tokens(self.attn.partial(y), g) + self.attn.proj.bias.to(dt)
        y = gather_tokens(self.norm2.rounded(x), g, self.length)
        return x + scatter_tokens(self.mlp.partial(y), g) + self.mlp.fc2.bias.to(dt)


class TemporalEncoder(nn.Module):
    """Year and day-of-year sincos encoding of (B, T, 2) ``temporal_coords``
    (reference pritvhi.py:273-322): half the dims each, times ``scale``
    (learnable, 0.1 at init, with ``trainable_scale``; else 1), (B, T, D)
    float32, one row per frame."""

    def __init__(self, embed_dim: int, trainable_scale: bool = False) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.scale = nn.Parameter(torch.full((1,), 0.1)) if trainable_scale else None

    def forward(self, temporal_coords: torch.Tensor) -> torch.Tensor:
        b, t, _ = temporal_coords.shape
        year_dim = self.embed_dim // 2
        year = _sincos_from_values(year_dim, temporal_coords[:, :, 0]).reshape(b, t, -1)
        jday = _sincos_from_values(self.embed_dim - year_dim,
                                  temporal_coords[:, :, 1]).reshape(b, t, -1)
        emb = torch.cat([year, jday], dim=-1)
        if self.scale is not None:
            emb = self.scale * emb
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
    float32, then cast to the token dtype (``_add_coords``, inside the
    profiler's range ``instageo.model.coords``). Coords come on the input's
    device: (B, T, 2) year and day of year, (B, 2) latitude and longitude.
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
        quant: str = "none",
        remat: bool = False,
    ) -> None:
        super().__init__()
        self.img_size = img_size
        self.patch_size = tuple(patch_size)
        self.num_frames = num_frames
        self.embed_dim = embed_dim
        self.coords_encoding = tuple(coords_encoding)
        self.patch_embed = PatchEmbed3D(self.patch_size, in_chans, embed_dim, dtype)
        if "time" in coords_encoding:
            self.temporal_embed_enc = TemporalEncoder(embed_dim, coords_scale_learn)
        if "location" in coords_encoding:
            self.location_embed_enc = LocationEncoder(embed_dim, coords_scale_learn)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, attn_impl, dtype, gelu, quant, remat)
            for _ in range(depth))
        self.norm = LayerNormF32(embed_dim)
        self.pipeline = None  # ``parallel/pp.py:Pipeline`` under pipeline parallelism
        self.sp_group = None  # the ``model`` group under sequence parallelism
        self._pos_cache: Dict[tuple, torch.Tensor] = {}

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        return (
            self.num_frames // self.patch_size[0],
            self.img_size // self.patch_size[1],
            self.img_size // self.patch_size[2],
        )

    @property
    def num_patches(self) -> int:
        gt, gh, gw = self.grid_size
        return gt * gh * gw

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
        if self.coords_encoding:
            with span("instageo.model.coords"):
                tokens = self._add_coords(tokens, temporal_coords, location_coords)
        cls = (self.cls_token + pos[:, :1]).to(tokens.dtype)
        tokens = torch.cat([cls.expand(tokens.shape[0], -1, -1), tokens], dim=1)
        return self.norm(self._blocks(tokens))

    def _add_coords(self, tokens: torch.Tensor, temporal_coords: Optional[torch.Tensor],
                    location_coords: Optional[torch.Tensor]) -> torch.Tensor:
        """The patch tokens (B, T·h·w, D) plus the embeddings of the coords
        given, each computed in float32 and cast to the tokens' dtype: a
        frame's temporal embedding broadcast over its tokens, the location
        embedding over every token. The coords are on the tokens' device.
        Counted: ``coord_embeds`` when an embedding was added,
        ``coords_missing`` when an encoder got no coords. Coords on another
        device raise: moving them here would hold the host on a pageable
        copy (the fused predict stages them with the batch)."""
        b, n, d = tokens.shape
        for name, c in (("temporal_coords", temporal_coords),
                        ("location_coords", location_coords)):
            if c is not None and c.device != tokens.device:
                raise ValueError(f"{name} on {c.device}; the model runs on {tokens.device}")
        added = missing = False
        if hasattr(self, "temporal_embed_enc"):
            if temporal_coords is None:
                missing = True
            else:
                t = temporal_coords.shape[1]
                emb = self.temporal_embed_enc(temporal_coords).to(tokens.dtype)
                tokens = (tokens.view(b, t, n // t, d) + emb[:, :, None]).view(b, n, d)
                added = True
        if hasattr(self, "location_embed_enc"):
            if location_coords is None:
                missing = True
            else:
                tokens = tokens + self.location_embed_enc(location_coords).to(tokens.dtype)
                added = True
        if added:
            coord_embeds.add()
        if missing:
            coords_missing.add()
        return tokens

    def _blocks(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.pipeline is not None:
            from instageo_tpu_torch.parallel.pp import pipeline_blocks

            return pipeline_blocks(self.blocks, tokens, self.pipeline)
        if self.sp_group is not None:
            from instageo_tpu_torch.parallel.tp import chunk_tokens, gather_tokens

            length = tokens.shape[1]
            tokens = chunk_tokens(tokens, self.sp_group)
            for block in self.blocks:
                block.length = length
                tokens = block(tokens)
            return gather_tokens(tokens, self.sp_group, length, reduce_grad=False)
        for block in self.blocks:
            tokens = block(tokens)
        return tokens
