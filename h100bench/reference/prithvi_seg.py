"""Plain PyTorch reference of the Prithvi segmentation model: the ViT
encoder and the upscaling ("torch") head, its preprocessing, its training
loss and AdamW.

It follows the published Prithvi encoder (a ViT over 3D patches with a
fixed 3D sincos position embedding and a cls token; pre-LN blocks with
exact GELU) and InstaGeo's segmentation head (four stages of
ConvTranspose2d(k3, s2) -> dropout -> Conv2d(k, padding 1) -> BatchNorm ->
ReLU that halve the channels, then dropout and a 1x1 classifier).
Parameter names are the timm / reference state-dict keys.

Everything runs in float32 (TF32 off, ``exact_float32``). ``quant="fp8"``
is the control that the comparison has to fail: the reference computed one
precision below the configuration's bf16, holding in float8 e4m3 (a
dynamic absmax scale per row of tokens, per sample of a feature map, per
output channel of a weight) every tensor that the program holds in bf16:
the operands and results of every matmul and convolution, the residual
stream, the LayerNorm and GELU outputs, the head's activations, and in the
backward the gradients of each of them. The head's dropout
draws its keep mask from the Philox4x32-10 stream of ``philox_bits`` below,
a frozen copy written from the stream's definition: element i takes word
i % 4 of Philox4x32-10(counter = (i / 4 as (lo, hi), 0, 0), key = seed as
(lo, hi)); keep = bits >= round(p * 2^32).

Nothing here imports the program under test or JAX.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_MOMENTUM = 0.1   # running <- (1 - 0.1) running + 0.1 batch (flax momentum 0.9)
BN_EPS = 1e-5
LN_EPS = 1e-5


def exact_float32() -> None:
    """float32 matmuls and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def float32_exact():
    """``exact_float32`` inside the block; the settings as they were after."""
    kept = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    exact_float32()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = kept[:2]
        torch.set_float32_matmul_precision(kept[2])


# ---------------------------------------------------------------------------
# Sizes and parameters
# ---------------------------------------------------------------------------


def head_channels(m: Dict) -> List[int]:
    """Channels into and out of the head's stages: D·T / 2^i, i = 0..4."""
    base = m["embed_dim"] * m["num_frames"] // m["patch_size"][0]
    return [base // (2 ** i) for i in range(5)]


def grid(m: Dict) -> Tuple[int, int, int]:
    pt, ph, pw = m["patch_size"]
    return m["num_frames"] // pt, m["img_size"] // ph, m["img_size"] // pw


def tokens(m: Dict) -> int:
    """Sequence length: the patches and the cls token."""
    gt, gh, gw = grid(m)
    return gt * gh * gw + 1


def param_spec(m: Dict) -> List[Tuple[str, Tuple[int, ...], Tuple]]:
    """(name, shape, init) of every parameter and buffer, in state-dict
    order. init: ("uniform", bound), ("normal", std), ("const", value) or
    ("range", lo, hi); ("count",) for BatchNorm's batch counter. Weights and
    biases of linear and convolution layers are U(±1/sqrt(fan_in)), with
    fan_in = shape[1] × the kernel's size (torch's default, ConvTranspose2d
    included); norms start at 1 and 0; the cls token is N(0, 0.02);
    BatchNorm's running statistics are drawn so that eval mode does real
    work: mean U(-0.5, 0.5), var U(0.5, 2)."""
    d, c = m["embed_dim"], m["in_chans"]
    hidden = int(d * m["mlp_ratio"])
    spec = []

    def dense(name, shape, out_dim=0):
        fan_in = shape[1] * int(np.prod(shape[2:], dtype=np.int64))
        b = 1.0 / math.sqrt(fan_in)
        spec.append((f"{name}.weight", tuple(shape), ("uniform", b)))
        spec.append((f"{name}.bias", (shape[out_dim],), ("uniform", b)))

    def norm(name, n):
        spec.append((f"{name}.weight", (n,), ("const", 1.0)))
        spec.append((f"{name}.bias", (n,), ("const", 0.0)))

    enc = "prithvi_encoder"
    spec.append((f"{enc}.cls_token", (1, 1, d), ("normal", 0.02)))
    dense(f"{enc}.patch_embed.proj", (d, c) + tuple(m["patch_size"]))
    for i in range(m["depth"]):
        blk = f"{enc}.blocks.{i}"
        norm(f"{blk}.norm1", d)
        dense(f"{blk}.attn.qkv", (3 * d, d))
        dense(f"{blk}.attn.proj", (d, d))
        norm(f"{blk}.norm2", d)
        dense(f"{blk}.mlp.fc1", (hidden, d))
        dense(f"{blk}.mlp.fc2", (d, hidden))
    norm(f"{enc}.norm", d)
    ch = head_channels(m)
    for i, k in enumerate(m["head_kernels"]):
        stage = f"segmentation_head.{i}"
        # ConvTranspose2d's weight is (in, out, k, k); torch's fan_in is
        # taken from dim 1 all the same.
        dense(f"{stage}.0", (ch[i], ch[i + 1], 3, 3), out_dim=1)
        dense(f"{stage}.2", (ch[i + 1], ch[i + 1], k, k))
        norm(f"{stage}.3", ch[i + 1])
        spec.append((f"{stage}.3.running_mean", (ch[i + 1],), ("range", -0.5, 0.5)))
        spec.append((f"{stage}.3.running_var", (ch[i + 1],), ("range", 0.5, 2.0)))
        spec.append((f"{stage}.3.num_batches_tracked", (), ("count",)))
    dense("segmentation_head.5", (m["num_classes"], ch[4], 1, 1))
    return spec


def dropout_shapes(m: Dict, batch: int) -> List[Tuple[int, ...]]:
    """Shapes of the head's dropout inputs for one forward over ``batch``
    chips, in call order."""
    ch = head_channels(m)
    side = m["img_size"] // m["patch_size"][1]
    shapes = []
    for i, k in enumerate(m["head_kernels"]):
        side = side * 2                       # ConvTranspose2d(k3, s2, p1, op1)
        shapes.append((batch, ch[i + 1], side, side))
        side = side + 2 - k + 1               # Conv2d(k, padding 1)
    shapes.append((batch, ch[4], side, side))
    return shapes


# ---------------------------------------------------------------------------
# The frozen Philox stream of the head's dropout
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_CHUNK = 1 << 24  # elements per block of the stream


def _mulhilo(mul: int, x: torch.Tensor):
    a = mul * (x & 0xFFFF)
    b = mul * (x >> 16)
    low = a + ((b & 0xFFFF) << 16)
    return (b >> 16) + (low >> 32), low & _M32


def _philox_block(first_group: int, n_groups: int, seed: int, device) -> torch.Tensor:
    g = torch.arange(first_group, first_group + n_groups, dtype=torch.int64, device=device)
    c0, c1 = g & _M32, g >> 32
    c2 = torch.zeros_like(g)
    c3 = torch.zeros_like(g)
    k0, k1 = seed & _M32, seed >> 32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return torch.stack((c0, c1, c2, c3), dim=-1).reshape(-1)


def keep_mask(shape: Sequence[int], p: float, seed: int, device) -> torch.Tensor:
    """The keep mask of dropout at rate ``p`` for a contiguous tensor of
    ``shape`` under ``seed`` (elements in row-major order, from 0)."""
    seed %= 1 << 64
    numel = int(np.prod(shape, dtype=np.int64))
    thresh = min(int(round(p * (1 << 32))), (1 << 32) - 1)
    out = torch.empty(numel, dtype=torch.bool, device=device)
    for start in range(0, numel, _CHUNK):
        n = min(_CHUNK, numel - start)
        words = _philox_block(start // 4, (n + 3) // 4, seed, device)
        out[start:start + n] = words[:n] >= thresh
    return out.reshape(tuple(shape))


def draw_seed(generator: torch.Generator) -> int:
    """One 63-bit seed from a CPU generator: how the program under test
    draws each dropout call's seed, and each step's generator seed, from
    the generator it is handed."""
    return int(torch.randint(0, 2**63 - 1, (), generator=generator))


def step_seeds(generator: torch.Generator, n_steps: int, calls_per_step: int) -> List[List[int]]:
    """The dropout seeds of ``n_steps`` optimizer steps drawn from the
    epoch ``generator``: each step seeds a generator of its own from one
    draw, and each dropout call of the step draws from that."""
    out = []
    for _ in range(n_steps):
        step_gen = torch.Generator().manual_seed(draw_seed(generator))
        out.append([draw_seed(step_gen) for _ in range(calls_per_step)])
    return out


# ---------------------------------------------------------------------------
# float8 (the control)
# ---------------------------------------------------------------------------


def _fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """x rounded to float8 e4m3 with a symmetric absmax scale per slice over
    ``dims``, back in float32."""
    scale = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _HeldInFp8(torch.autograd.Function):
    """A tensor the program holds in bf16, held in float8 instead: the
    value in the forward, and its gradient in the backward."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        return _fp8(x, dims)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, ctx.dims), None


def _r(x: torch.Tensor, quant: Optional[str], dims=(-1,)) -> torch.Tensor:
    """x (and its gradient) held in ``quant`` ("fp8": float8 e4m3, one
    absmax scale per slice over ``dims``) where the program holds bf16;
    x itself without ``quant``."""
    if not quant:
        return x
    if quant != "fp8":
        raise ValueError(f"quant={quant!r}")
    return _HeldInFp8.apply(x, tuple(dims))


def _rs(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """``_r`` with one scale per sample (a feature map)."""
    return _r(x, quant, tuple(range(1, x.dim())))


def _lin(x, w, b, quant):
    return _r(F.linear(_r(x, quant), _r(w, quant), b), quant)


def _conv(fn, x, w, b, quant, w_dims=None, **kw):
    if quant:
        x = _rs(x, quant)
        w = _r(w, quant, w_dims if w_dims is not None else tuple(range(1, w.dim())))
    return _rs(fn(x, w, b, **kw), quant)


def _matmul(a, b, quant):
    return _r(torch.matmul(_r(a, quant), _r(b, quant, (-2,))), quant)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.outer(pos.astype(np.float64).reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def pos_embed(m: Dict) -> torch.Tensor:
    """(1, L, D) fixed 3D sincos embedding, the cls token's row (zeros)
    first: the dims split 4:6:6 (t:h:w) in units of D/16 and concatenate in
    (w, h, t) order; tokens are t-major, then h, then w."""
    d = m["embed_dim"]
    t, h, w = grid(m)
    w_pos = _sincos_1d(d // 16 * 6, np.arange(w))
    h_pos = _sincos_1d(d // 16 * 6, np.arange(h))
    t_pos = _sincos_1d(d // 16 * 4, np.arange(t))
    w_pos = np.tile(w_pos, (t * h, 1))
    h_pos = np.tile(np.repeat(h_pos, w, axis=0), (t, 1))
    t_pos = np.repeat(t_pos, h * w, axis=0)
    pe = np.concatenate([np.zeros((1, d)), np.concatenate([w_pos, h_pos, t_pos], axis=1)])
    return torch.from_numpy(pe.astype(np.float32))[None]


def preprocess(raw: torch.Tensor, pre: Dict) -> torch.Tensor:
    """Raw (B, T·C_raw, H, W) integer chips -> normalised (B, C, T, H, W)
    float32: band select, constant multiplier, per-band mean and std,
    centre crop to the model's input size."""
    x = raw.to(torch.float32)
    if pre.get("bands") is not None:
        x = x[:, list(pre["bands"])]
    size = int(pre["img_size"])
    h, w = x.shape[-2:]
    oh, ow = (h - size) // 2, (w - size) // 2
    x = x[..., oh:oh + size, ow:ow + size]
    b, tc = x.shape[:2]
    t = int(pre["temporal_size"])
    x = x * float(pre["constant_multiplier"])
    x = x.reshape(b, t, tc // t, size, size)
    mean = torch.tensor(pre["mean"], dtype=torch.float32, device=x.device)
    std = torch.tensor(pre["std"], dtype=torch.float32, device=x.device)
    x = (x - mean[None, None, :, None, None]) / std[None, None, :, None, None]
    return x.permute(0, 2, 1, 3, 4).contiguous()


def _block(x, p, pre, heads, quant):
    b, l, d = x.shape
    dh = d // heads
    y = _r(F.layer_norm(x, (d,), p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"], LN_EPS),
           quant)
    qkv = _lin(y, p[f"{pre}.attn.qkv.weight"], p[f"{pre}.attn.qkv.bias"], quant)
    q, k, v = qkv.reshape(b, l, 3, heads, dh).permute(2, 0, 3, 1, 4)
    scores = _matmul(q * dh ** -0.5, k.transpose(-1, -2), quant)
    attn = _matmul(torch.softmax(scores, dim=-1), v, quant)
    attn = attn.transpose(1, 2).reshape(b, l, d)
    x = _r(x + _lin(attn, p[f"{pre}.attn.proj.weight"], p[f"{pre}.attn.proj.bias"], quant),
           quant)
    y = _r(F.layer_norm(x, (d,), p[f"{pre}.norm2.weight"], p[f"{pre}.norm2.bias"], LN_EPS),
           quant)
    y = _r(F.gelu(_lin(y, p[f"{pre}.mlp.fc1.weight"], p[f"{pre}.mlp.fc1.bias"], quant)), quant)
    return _r(x + _lin(y, p[f"{pre}.mlp.fc2.weight"], p[f"{pre}.mlp.fc2.bias"], quant), quant)


def encoder(p: Dict[str, torch.Tensor], x: torch.Tensor, m: Dict, quant: Optional[str] = None,
            remat: bool = False) -> torch.Tensor:
    """(B, C, T, H, W) -> (B, L, D) tokens after the final LayerNorm, the
    cls token first. ``remat`` recomputes each block in the backward."""
    enc = "prithvi_encoder"
    w = p[f"{enc}.patch_embed.proj.weight"]
    t = _conv(F.conv3d, x, w, p[f"{enc}.patch_embed.proj.bias"], quant,
              stride=tuple(m["patch_size"]))
    t = t.flatten(2).transpose(1, 2)                       # (B, L-1, D), t-major
    pe = pos_embed(m).to(x.device)
    t = _r(t + pe[:, 1:], quant)
    cls = _r(p[f"{enc}.cls_token"] + pe[:, :1], quant).expand(t.shape[0], -1, -1)
    t = torch.cat([cls, t], dim=1)
    for i in range(m["depth"]):
        pre = f"{enc}.blocks.{i}"
        if remat and torch.is_grad_enabled():
            t = checkpoint(_block, t, p, pre, m["num_heads"], quant, use_reentrant=False)
        else:
            t = _block(t, p, pre, m["num_heads"], quant)
    return F.layer_norm(t, (t.shape[-1],), p[f"{enc}.norm.weight"], p[f"{enc}.norm.bias"], LN_EPS)


def _dropout(x, rate, seeds, device):
    if seeds is None:
        return x
    mask = keep_mask(x.shape, rate, seeds.pop(0), device)
    return torch.where(mask, x * (1.0 / (1.0 - rate)), torch.zeros((), device=x.device))


def _batch_norm(x, p, pre, train, stats_out):
    if not train:
        return F.batch_norm(x, p[f"{pre}.running_mean"], p[f"{pre}.running_var"],
                            p[f"{pre}.weight"], p[f"{pre}.bias"], False, 0.0, BN_EPS)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    if stats_out is not None:
        stats_out.append((pre, mean.detach(), var.detach()))
    xn = (x - mean[None, :, None, None]) * torch.rsqrt(var[None, :, None, None] + BN_EPS)
    return xn * p[f"{pre}.weight"][None, :, None, None] + p[f"{pre}.bias"][None, :, None, None]


def head(p: Dict[str, torch.Tensor], tok: torch.Tensor, m: Dict, *, quant=None,
         drop_seeds: Optional[List[int]] = None, stats_out: Optional[list] = None,
         rate: float = 0.1, batch_stats: bool = False) -> torch.Tensor:
    """Tokens -> (B, classes, H, W) logits. Train mode (``drop_seeds`` a
    list of the forward's dropout seeds, consumed in call order): dropout
    at ``rate`` and BatchNorm on batch statistics, whose (name, mean,
    biased var) go to ``stats_out``; eval mode: BatchNorm on the running
    statistics, no dropout; ``batch_stats``: no dropout, BatchNorm on
    batch statistics."""
    train = drop_seeds is not None or batch_stats
    feats = tok[:, 1:]
    b, l, d = feats.shape
    t = m["num_frames"] // m["patch_size"][0]
    side = int(round((l // t) ** 0.5))
    x = feats.reshape(b, t, side, side, d).permute(0, 4, 1, 2, 3).reshape(b, d * t, side, side)
    for i, k in enumerate(m["head_kernels"]):
        pre = f"segmentation_head.{i}"
        # ConvTranspose2d's weight is (in, out, k, k): per output channel is dim 1.
        x = _conv(F.conv_transpose2d, x, p[f"{pre}.0.weight"], p[f"{pre}.0.bias"], quant,
                  w_dims=(0, 2, 3), stride=2, padding=1, output_padding=1)
        x = _dropout(x, rate, drop_seeds, x.device)
        x = _conv(F.conv2d, x, p[f"{pre}.2.weight"], p[f"{pre}.2.bias"], quant, padding=1)
        x = _rs(F.relu(_batch_norm(x, p, f"{pre}.3", train, stats_out)), quant)
    x = _dropout(x, rate, drop_seeds, x.device)
    return _conv(F.conv2d, x, p["segmentation_head.5.weight"], p["segmentation_head.5.bias"],
                 quant)


def logits(p, x, m, quant=None, **head_kw) -> torch.Tensor:
    return head(p, encoder(p, x, m, quant, remat=head_kw.pop("remat", False)), m,
                quant=quant, **head_kw)


@torch.no_grad()
def calibrate_bn(p: Dict[str, torch.Tensor], raw: torch.Tensor, m: Dict, pre: Dict
                 ) -> Dict[str, torch.Tensor]:
    """BatchNorm running statistics as training on such chips leaves them:
    each BatchNorm's batch mean and biased variance over ``raw``'s chips
    (float32). With them, eval mode maps these chips as batch statistics
    would."""
    stats: list = []
    head(p, encoder(p, preprocess(raw, pre), m), m, batch_stats=True, stats_out=stats)
    out = {}
    for name, mean, var in stats:
        out[f"{name}.running_mean"] = mean
        out[f"{name}.running_var"] = var
    return out


@torch.no_grad()
def serve_logits(p, raw: torch.Tensor, m: Dict, pre: Dict, quant=None,
                 block: int = 16) -> torch.Tensor:
    """Eval-mode logits (B, classes, H, W) of raw chips, ``block`` chips at
    a time."""
    out = []
    for i in range(0, raw.shape[0], block):
        out.append(logits(p, preprocess(raw[i:i + block], pre), m, quant))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def masked_ce(lg: torch.Tensor, labels: torch.Tensor, weights, ignore: int) -> torch.Tensor:
    """Σ w[y]·nll(y) over valid pixels / max(valid pixels, 1)."""
    valid = labels != ignore
    safe = labels.clamp(0, lg.shape[1] - 1)
    logp = torch.log_softmax(lg, dim=1)
    nll = -logp.gather(1, safe[:, None]).squeeze(1)
    if weights is not None:
        nll = nll * weights[safe]
    v = valid.float()
    return (nll * v).sum() / v.sum().clamp_min(1.0)


def train_steps(p: Dict[str, torch.Tensor], m: Dict, tr: Dict,
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                seeds: Sequence[Sequence[int]], *, quant=None, fault=None) -> Dict:
    """The program's training steps, one per batch, from the state ``p``
    (float32 parameters and BatchNorm buffers, updated in place): the
    batch splits into ``grad_accum`` micro-batches, each weighted by its
    share of the batch's valid pixels; AdamW (β 0.9 / 0.999, eps 1e-8,
    decoupled decay on every parameter). Returns each step's loss and the
    first step's gradient of each parameter; the state after the last step
    is left in ``p``.

    ``fault`` plants a fault of the kind the comparison must catch:
    ``"half_batch"`` takes the loss over the first half of each
    micro-batch only."""
    if fault not in (None, "half_batch"):
        raise ValueError(f"unknown fault {fault!r}")
    names = [n for n in p if _trainable(n)]
    for n in names:
        p[n].requires_grad_(True)
    exp_avg = {n: torch.zeros_like(p[n]) for n in names}
    exp_sq = {n: torch.zeros_like(p[n]) for n in names}
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr, wd = float(tr["learning_rate"]), float(tr["weight_decay"])
    accum = int(tr.get("grad_accum", 1))
    weights = tr.get("class_weights")
    losses, grad1 = [], None
    for step, ((x, y), step_seeds_) in enumerate(zip(batches, seeds), start=1):
        seeds_left = list(step_seeds_)
        mb = x.shape[0] // accum
        w = (y != tr["ignore_index"]).reshape(accum, -1).sum(dim=1).float()
        w_total = w.sum().clamp_min(1.0)
        cw = None if weights is None else torch.tensor(weights, dtype=torch.float32,
                                                       device=x.device)
        grads = {n: torch.zeros_like(p[n]) for n in names}
        total = 0.0
        for i in range(accum):
            xb, yb = x[i * mb:(i + 1) * mb], y[i * mb:(i + 1) * mb]
            stats = []
            drop = [seeds_left.pop(0) for _ in range(len(m["head_kernels"]) + 1)]
            lg = logits(p, xb, m, quant, drop_seeds=drop, stats_out=stats, remat=True)
            if fault == "half_batch":
                h = xb.shape[0] // 2
                loss = masked_ce(lg[:h], yb[:h], cw, tr["ignore_index"])
            else:
                loss = masked_ce(lg, yb, cw, tr["ignore_index"])
            g = torch.autograd.grad(loss * (w[i] / w_total), [p[n] for n in names])
            for n, gi in zip(names, g):
                grads[n] += gi
            total += float(loss.detach()) * float(w[i] / w_total)
            with torch.no_grad():
                for pre, mean, var in stats:
                    p[f"{pre}.running_mean"].lerp_(mean, BN_MOMENTUM)
                    p[f"{pre}.running_var"].lerp_(var, BN_MOMENTUM)
            del lg, loss, g
        losses.append(total)
        if grad1 is None:
            grad1 = {n: grads[n].clone() for n in names}
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for n in names:
                pn, g = p[n], grads[n]
                pn.mul_(1 - lr * wd)
                exp_avg[n].mul_(b1).add_(g, alpha=1 - b1)
                exp_sq[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = exp_sq[n].sqrt() / math.sqrt(bc2) + eps
                pn.addcdiv_(exp_avg[n], denom, value=-lr / bc1)
        del grads
    for n in names:
        p[n].requires_grad_(False)
    return {"losses": losses, "grad1": grad1}


def _trainable(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var", "num_batches_tracked"))


def flops_per_chip(m: Dict) -> float:
    """FLOPs of one chip's forward (matmuls and convolutions), counted by
    ``torch.utils.flop_counter`` over this reference on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    p = {}
    for name, shape, init in param_spec(m):
        dtype = torch.int64 if init[0] == "count" else torch.float32
        p[name] = torch.empty(shape, dtype=dtype, device="meta")
    x = torch.empty((1, m["in_chans"], m["num_frames"], m["img_size"], m["img_size"]),
                    device="meta")
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            logits(p, x, m)
    return float(counter.get_total_flops())
