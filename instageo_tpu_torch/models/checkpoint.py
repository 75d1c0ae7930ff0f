"""Weight bridge: JAX ``PrithviSeg`` variables -> the port's state dict.

The port's own copy of the mapping in
``instageo_tpu/models/checkpoint.py:seg_variables_to_torch``: the JAX tree
(``{"params", "batch_stats"}`` as numpy arrays) becomes the reference/timm
state-dict layout that ``PrithviSeg.load_state_dict(..., strict=True)``
takes.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from instageo_tpu_torch.models.registry import PrithviArch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _linear(sd: Dict, prefix: str, p: Mapping) -> None:
    """Dense kernel (in, out) -> Linear weight (out, in)."""
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _encoder(sd: Dict, params: Mapping, arch: PrithviArch) -> None:
    if "temporal_embed_enc" in params or "location_embed_enc" in params:
        raise NotImplementedError(
            "temporal/location encoders (_tl variants) are not ported yet")
    pre = "prithvi_encoder"
    kernel = np.asarray(params["patch_embed"]["proj"]["kernel"])  # (C·p, D)
    patch = tuple(arch.patch_size)
    d = kernel.shape[1]
    c = kernel.shape[0] // int(np.prod(patch))
    # Rows are ordered (c, pt, ph, pw): the Conv3d weight's contraction order.
    sd[f"{pre}.patch_embed.proj.weight"] = _t(kernel.T.reshape(d, c, *patch))
    sd[f"{pre}.patch_embed.proj.bias"] = _t(params["patch_embed"]["proj"]["bias"])
    sd[f"{pre}.cls_token"] = _t(params["cls_token"])
    for i in range(arch.depth):
        blk = params[f"blocks_{i}"]
        bp = f"{pre}.blocks.{i}"
        _layernorm(sd, f"{bp}.norm1", blk["norm1"])
        _layernorm(sd, f"{bp}.norm2", blk["norm2"])
        # Head-structured qkv (D, 3, H, Dh) -> fused Linear (3D, D); the
        # output columns stay ordered (3, H, Dh).
        qkv = blk["attn"]["qkv"]
        qk = np.asarray(qkv["kernel"])
        sd[f"{bp}.attn.qkv.weight"] = _t(qk.reshape(qk.shape[0], -1).T)
        sd[f"{bp}.attn.qkv.bias"] = _t(np.asarray(qkv["bias"]).reshape(-1))
        _linear(sd, f"{bp}.attn.proj", blk["attn"]["proj"])
        _linear(sd, f"{bp}.mlp.fc1", blk["mlp"]["fc1"])
        _linear(sd, f"{bp}.mlp.fc2", blk["mlp"]["fc2"])
    _layernorm(sd, f"{pre}.norm", params["norm"])


def seg_state_dict_from_jax(variables: Mapping, arch: PrithviArch,
                            num_up_blocks: int = 4) -> Dict[str, torch.Tensor]:
    """JAX ``PrithviSeg`` variables (numpy) -> the port's float32 state dict.

    Head blocks are ``segmentation_head.{i}`` = [ConvT, Dropout, Conv, BN,
    ReLU]; the classifier is ``segmentation_head.{num_up_blocks + 1}``
    (Dropout holds the slot before it). ``arch`` must carry the depth the
    variables were built with.
    """
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    _encoder(sd, params["prithvi_encoder"], arch)
    for i in range(num_up_blocks):
        up = params[f"up_{i}"]
        base = f"segmentation_head.{i}"
        # Flipped-HWIO correlation kernel -> ConvTranspose2d (I, O, kh, kw).
        k = np.asarray(up["convt"]["kernel"])[::-1, ::-1]
        sd[f"{base}.0.weight"] = _t(k.transpose(2, 3, 0, 1))
        sd[f"{base}.0.bias"] = _t(up["convt"]["bias"])
        # HWIO -> OIHW.
        sd[f"{base}.2.weight"] = _t(np.asarray(up["conv"]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{base}.2.bias"] = _t(up["conv"]["bias"])
        sd[f"{base}.3.weight"] = _t(up["bn"]["scale"])
        sd[f"{base}.3.bias"] = _t(up["bn"]["bias"])
        stats = batch_stats.get(f"up_{i}", {}).get("bn", {})
        sd[f"{base}.3.running_mean"] = _t(
            stats.get("mean", np.zeros_like(up["bn"]["bias"])))
        sd[f"{base}.3.running_var"] = _t(
            stats.get("var", np.ones_like(up["bn"]["scale"])))
    head = f"segmentation_head.{num_up_blocks + 1}"
    sd[f"{head}.weight"] = _t(np.asarray(params["head_conv"]["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{head}.bias"] = _t(params["head_conv"]["bias"])
    return sd
