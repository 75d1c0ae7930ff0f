"""Model factory: run config -> ``PrithviSeg`` on the device, with weights.

Counterpart of ``instageo_tpu/train/factory.py``. ``build_model`` sizes the
model from the config (segmentation, or ``num_classes=1`` under
``is_reg_task``); ``create_model`` loads weights in the JAX package's
order: ``checkpoint_path``, else a local pretrained encoder
(``model.pretrained_path`` or ``PRITHVI_PRETRAINED_PATH``) with band
surgery, else a fresh init from the seed.

The ``tpu:`` section of a config is read through ``TPU_KEYS``, which says
for each key what the port does with it on one card.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import torch

from instageo_tpu_torch.device import resolve_device
from instageo_tpu_torch.models.checkpoint import (
    load_pretrained_encoder,
    load_torch_file,
    seg_state_dict_from_torch,
)
from instageo_tpu_torch.models.registry import PRETRAINED_BANDS, get_arch
from instageo_tpu_torch.models.seg import HEADS, PrithviSeg, create_prithvi_seg
from instageo_tpu_torch.train.checkpointing import load_checkpoint

log = logging.getLogger(__name__)

# What the port does with each ``tpu.*`` key of the JAX config:
#   ("honoured", allowed values)  - read and acted on;
#   ("accepted", allowed values)  - validated, with no meaning on one card;
#   ("refused", allowed, item)    - any other value raises
#                                   NotImplementedError naming the ROADMAP item.
# Every attention and dropout value takes the port's kernel route: the port
# has no XLA path. ``steps_per_call`` (``steps_per_call()``) groups k
# optimizer steps into one CUDA graph on the card; ``prefetch_depth`` bounds
# the thread loader's queue. Keys the JAX package does not read are ignored,
# as there.
TPU_KEYS = {
    "precision": ("honoured", ("bf16", "f32")),
    "profile": ("honoured", (False, True)),
    "steps_per_call": ("honoured", None),
    "prefetch_depth": ("honoured", None),
    "mesh": ("accepted", ("auto", 1)),
    "donate_state": ("accepted", (True, False)),
    "rng_impl": ("accepted", ("auto", "rbg", "threefry")),
    "attn_impl": ("accepted", ("xla", "pallas", "auto")),
    "attn_interpret": ("accepted", (False, True)),
    "dropout_impl": ("accepted", ("xla", "bits16", "bits8", "pallas")),
    "bf16_transfer": ("accepted", (True, False)),
    "pp_microbatches": ("accepted", None),
    "tp": ("refused", (1,), "ROADMAP item 11 (parallel/)"),
    "pp": ("refused", (1,), "ROADMAP item 11 (parallel/)"),
    "sp": ("refused", (False,), "ROADMAP item 11 (parallel/)"),
    "fsdp": ("refused", (False,), "ROADMAP item 11 (parallel/)"),
    "zero1": ("refused", (False,), "ROADMAP item 11 (parallel/)"),
    "quant": ("refused", ("none",), "ROADMAP item 10 (ops/quant.py)"),
    "block_layout": ("refused", ("loop", "scan"), "ROADMAP item 11 (parallel/, pp)"),
    "remat": ("refused", (False,), "ROADMAP item 11 (parallel/)"),
    "gelu": ("honoured", ("exact", "tanh", "bf16")),
}
# ``block_layout: scan`` builds the same modules as ``loop`` (the weight
# bridge reads a stacked JAX tree); ``pipeline`` waits for ROADMAP item 11.


def check_tpu_config(cfg: Any) -> dict:
    """Validate the ``tpu:`` section against ``TPU_KEYS``; returns it."""
    tpu_cfg = cfg.get("tpu") or {}
    for key, value in tpu_cfg.items():
        rule = TPU_KEYS.get(key)
        if rule is None:
            continue
        if rule[0] == "refused":
            if value not in rule[1]:
                raise NotImplementedError(
                    f"tpu.{key}={value!r} is not ported yet: {rule[2]}")
        elif rule[1] is not None and value not in rule[1]:
            raise ValueError(f"tpu.{key}={value!r} — expected one of {rule[1]}")
    return tpu_cfg


def _k_cap(batch_size: int, sample_bytes: int) -> int:
    """The largest k <= 8 whose staged (k, B, ...) input batches stay under
    512 MB of device memory."""
    return max(1, min(8, (512 << 20) // max(batch_size * sample_bytes, 1)))


def steps_per_call(cfg: Any, device_type: str, in_chans: int,
                   batch_size: Optional[int] = None) -> int:
    """The optimizer steps one call runs, the JAX trainer's rule for
    ``tpu.steps_per_call``: an integer k as given; ``auto`` on the
    accelerator (a CUDA device) the ``_k_cap`` for ``batch_size``
    (``train.batch_size`` by default), with in_chans × T × img² input values
    per sample at 2 bytes (bf16 transfer) or 4; ``auto`` elsewhere 1."""
    tpu_cfg = cfg.get("tpu") or {}
    spc = tpu_cfg.get("steps_per_call", 1)
    if str(spc) != "auto":
        if isinstance(spc, bool) or not isinstance(spc, int) or spc < 1:
            raise ValueError(f"tpu.steps_per_call={spc!r} — expected auto or an integer >= 1")
        return spc
    if device_type != "cuda":
        return 1
    dl = cfg.get("dataloader") or {}
    bf16 = str(tpu_cfg.get("precision", "bf16")) == "bf16" and bool(
        tpu_cfg.get("bf16_transfer", True))
    sample_bytes = (int(in_chans) * int(dl.get("temporal_dim", 1))
                    * int(dl.get("img_size", 224)) ** 2 * (2 if bf16 else 4))
    if batch_size is None:
        batch_size = int((cfg.get("train") or {}).get("batch_size", 8))
    return _k_cap(batch_size, sample_bytes)


def compute_dtype(cfg: Any) -> torch.dtype:
    prec = (cfg.get("tpu") or {}).get("precision", "bf16")
    return torch.bfloat16 if str(prec) == "bf16" else torch.float32


def model_channels(cfg: Any) -> int:
    """Per-frame model input channels implied by the dataloader config.

    Chip files stack frames channelwise ((T·C, H, W)) and
    ``dataloader.bands`` indexes that stacked axis: the multi-temporal
    configs list T·C entries while the model takes C = len(bands)/T
    channels per frame. When bands spans exactly T frames of ``len(mean)``
    channels it is ``len(mean)``, otherwise bands is the per-frame list.
    ``model.num_channels`` overrides the derivation.
    """
    explicit = (cfg.get("model") or {}).get("num_channels")
    if explicit:
        return int(explicit)
    dl = cfg.dataloader
    bands = dl.get("bands")
    mean = dl.get("mean")
    c = len(list(bands)) if bands else len(list(mean or [0] * 6))
    t = int(dl.get("temporal_dim", 1))
    if t > 1 and mean and c == t * len(list(mean)):
        return len(list(mean))
    return c


def _arch(cfg: Any):
    return get_arch(str(cfg.model.model_name), in_chans=model_channels(cfg),
                    num_frames=int(cfg.dataloader.get("temporal_dim", 1)),
                    img_size=int(cfg.dataloader.get("img_size", 224)),
                    depth=int(cfg.model.get("depth", -1)))


def build_model(cfg: Any, device=None, training: bool = False, seed: int = 0) -> PrithviSeg:
    """The ``PrithviSeg`` a config describes, on ``device`` (``cuda``
    unless the caller asks for the CPU), randomly initialised from
    ``seed``. Compute dtype from ``tpu.precision``; parameters float32 for
    ``training``, else in the compute dtype."""
    tpu_cfg = check_tpu_config(cfg)
    head_impl = str(cfg.model.get("head_impl", "torch"))
    if head_impl not in HEADS:
        raise ValueError(f"model.head_impl={head_impl!r} — expected one of {HEADS}")
    dtype = compute_dtype(cfg)
    return create_prithvi_seg(
        str(cfg.model.model_name),
        num_classes=1 if cfg.get("is_reg_task", False) else int(cfg.model.num_classes),
        temporal_step=int(cfg.dataloader.get("temporal_dim", 1)),
        image_size=int(cfg.dataloader.get("img_size", 224)),
        num_bands=model_channels(cfg),
        depth=int(cfg.model.get("depth", -1)),
        dtype=dtype,
        param_dtype=torch.float32 if training else dtype,
        head_impl=head_impl,
        gelu=str(tpu_cfg.get("gelu", "exact")),
        device=resolve_device(device),
        seed=seed,
    )


def create_model(cfg: Any, seed: int = 0, device=None, training: bool = False) -> PrithviSeg:
    """Build the model and load its weights, in this order:

    1. ``cfg.checkpoint_path`` set: the fine-tuned checkpoint (this
       package's checkpoint directory, or a reference ``.ckpt``/``.pt``/
       ``.npz``);
    2. else, with ``model.load_pretrained_weights`` and a local pretrained
       file: the encoder from it, with band surgery;
    3. else the fresh init from ``seed``.
    """
    model = build_model(cfg, device, training, seed)
    ckpt_path = cfg.get("checkpoint_path")
    if ckpt_path:
        return load_finetuned(str(ckpt_path), model)
    if cfg.model.get("load_pretrained_weights", False):
        pre_path = cfg.model.get("pretrained_path") or os.environ.get("PRITHVI_PRETRAINED_PATH")
        if pre_path and os.path.exists(pre_path):
            # The model's bands are the pretrained HLS bands tiled to its
            # channel count, so multiples of 6 copy the embedding per cycle.
            n_bands = model_channels(cfg)
            reps = -(-n_bands // len(PRETRAINED_BANDS))
            model_bands = (list(PRETRAINED_BANDS) * reps)[:n_bands]
            enc = load_pretrained_encoder(pre_path, _arch(cfg), model_bands=model_bands)
            missing, unexpected = model.prithvi_encoder.load_state_dict(enc, strict=False)
            # A _tl checkpoint without the encoders' learnable scales keeps
            # their init, as the JAX reader does; anything else must match.
            if unexpected or any(not k.endswith("_embed_enc.scale") for k in missing):
                raise RuntimeError(f"pretrained encoder {pre_path}: missing keys {missing}, "
                                   f"unexpected keys {unexpected}")
            log.info("Loaded pretrained encoder from %s", pre_path)
        else:
            log.warning("load_pretrained_weights=True but no local pretrained file "
                        "(set model.pretrained_path or PRITHVI_PRETRAINED_PATH); "
                        "using fresh init.")
    return model


def load_finetuned(path: str, model: PrithviSeg) -> PrithviSeg:
    """Load fine-tuned weights into ``model`` (strict): a checkpoint
    directory of this package, or a reference ``.ckpt``/``.pt``/``.npz``
    whose keys may carry a Lightning module prefix (``net.``)."""
    if os.path.isdir(path):
        state = load_checkpoint(path)["model"]
    else:
        state = seg_state_dict_from_torch(load_torch_file(path))
    model.load_state_dict(state, strict=True)
    return model


def build_teacher(cfg: Any, path: str, device=None) -> Optional[PrithviSeg]:
    """The frozen distillation teacher: the config's model with the
    weights at ``path``, in eval mode, without gradients."""
    teacher = load_finetuned(path, build_model(cfg, device, training=False))
    teacher.requires_grad_(False)
    return teacher.eval()
