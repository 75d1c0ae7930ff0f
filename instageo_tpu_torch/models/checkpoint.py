"""Weight bridges and checkpoint readers for the port's ``PrithviSeg``.

* ``seg_state_dict_from_jax``: the port's own copy of the mapping in
  ``instageo_tpu/models/checkpoint.py:seg_variables_to_torch``: the JAX
  tree (``{"params", "batch_stats"}`` as numpy arrays) becomes the
  reference/timm state-dict layout that ``PrithviSeg.load_state_dict(...,
  strict=True)`` takes; either head, the ``_tl`` encoders' scales, and the
  blocks in the loop layout (``blocks_{i}``) or stacked (one ``blocks``
  subtree with a leading depth axis, ``tpu.block_layout: scan``);
* ``export_torch_checkpoint``: the port's weights as the reference's
  Lightning ``.ckpt`` (``{"state_dict": ...}``, keys prefixed ``net.``) or
  an ``.npz``, what the JAX package's function of that name writes;
* the torch-checkpoint readers of the same JAX module (``load_torch_file``,
  ``filter_checkpoint_vit``, ``select_patch_embed_weights``,
  ``load_pretrained_encoder``), which here act on state dicts directly,
  since the port's keys are the reference's.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from instageo_tpu_torch.models.registry import PRETRAINED_BANDS, PrithviArch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _linear(sd: Dict, prefix: str, p: Mapping) -> None:
    """Dense kernel (in, out) -> Linear weight (out, in)."""
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm(sd: Dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def unstack_block_params(encoder_params: Mapping) -> Dict:
    """A stacked-layout encoder tree (one ``blocks`` subtree whose leaves
    carry a leading depth axis) in the loop layout (``blocks_0`` ...); a
    loop-layout tree as it is. The port's numpy copy of
    ``instageo_tpu/models/prithvi.py:unstack_block_params``."""
    if "blocks" not in encoder_params:
        return dict(encoder_params)
    out = {k: v for k, v in encoder_params.items() if k != "blocks"}
    stacked = encoder_params["blocks"]

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, Mapping) else (v,))

    def take(tree, i):
        return {k: take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
                for k, v in tree.items()}

    depth = int(np.shape(next(leaves(stacked)))[0])
    for i in range(depth):
        out[f"blocks_{i}"] = take(stacked, i)
    return out


def _encoder(sd: Dict, params: Mapping, arch: PrithviArch) -> None:
    params = unstack_block_params(params)
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
    for name in ("temporal_embed_enc", "location_embed_enc"):
        if "scale" in params.get(name, {}):
            sd[f"{pre}.{name}.scale"] = _t(np.reshape(params[name]["scale"], (1,)))


def _upscaling_block(sd: Dict, base: str, up: Mapping, stats: Mapping) -> None:
    """One JAX ``UpscalingBlock`` -> [ConvT, Dropout, Conv, BN, ReLU] at ``base``."""
    # Flipped-HWIO correlation kernel -> ConvTranspose2d (I, O, kh, kw).
    k = np.asarray(up["convt"]["kernel"])[::-1, ::-1]
    sd[f"{base}.0.weight"] = _t(k.transpose(2, 3, 0, 1))
    sd[f"{base}.0.bias"] = _t(up["convt"]["bias"])
    # HWIO -> OIHW.
    sd[f"{base}.2.weight"] = _t(np.asarray(up["conv"]["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{base}.2.bias"] = _t(up["conv"]["bias"])
    sd[f"{base}.3.weight"] = _t(up["bn"]["scale"])
    sd[f"{base}.3.bias"] = _t(up["bn"]["bias"])
    stats = stats.get("bn", {})
    sd[f"{base}.3.running_mean"] = _t(stats.get("mean", np.zeros_like(up["bn"]["bias"])))
    sd[f"{base}.3.running_var"] = _t(stats.get("var", np.ones_like(up["bn"]["scale"])))


def seg_state_dict_from_jax(variables: Mapping, arch: PrithviArch,
                            num_up_blocks: int = 4) -> Dict[str, torch.Tensor]:
    """JAX ``PrithviSeg`` variables (numpy) -> the port's float32 state dict.

    The torch head's blocks are ``segmentation_head.{i}`` = [ConvT,
    Dropout, Conv, BN, ReLU]; its classifier is
    ``segmentation_head.{num_up_blocks + 1}`` (Dropout holds the slot
    before it). A fast-head tree (``fast_up_{0,1,2}``, ``fast_head_conv``)
    keeps the JAX names. ``arch`` must carry the depth the variables were
    built with.
    """
    params = variables["params"]
    batch_stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    _encoder(sd, params["prithvi_encoder"], arch)
    if "fast_head_conv" in params:
        ups = [(f"fast_up_{i}", f"fast_up_{i}") for i in range(3)]
        head_src, head = "fast_head_conv", "fast_head_conv"
    else:
        ups = [(f"up_{i}", f"segmentation_head.{i}") for i in range(num_up_blocks)]
        head_src, head = "head_conv", f"segmentation_head.{num_up_blocks + 1}"
    for src, base in ups:
        _upscaling_block(sd, base, params[src], batch_stats.get(src, {}))
    sd[f"{head}.weight"] = _t(np.asarray(params[head_src]["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{head}.bias"] = _t(params[head_src]["bias"])
    return sd


# ---------------------------------------------------------------------------
# Reading torch checkpoints: pretrained encoders and fine-tuned models
# ---------------------------------------------------------------------------


def _unwrap_state_dict(state_dict: Mapping) -> Mapping:
    """The value of the first key ending in 'state_dict', else the mapping
    itself (a Lightning ``.ckpt`` keeps its weights under ``state_dict``)."""
    for k in state_dict.keys():
        if isinstance(k, str) and k.endswith("state_dict"):
            return state_dict[k]
    return state_dict


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pt``/``.ckpt`` (``torch.load(weights_only=True)``) or ``.npz``
    file as a flat name -> tensor dict."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(np.array(z[k])) for k in z.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"Unsupported checkpoint object in {path}: {type(obj)}")
    return {k: torch.as_tensor(v) for k, v in _unwrap_state_dict(obj).items()}


def _xavier_uniform(rng: np.random.Generator, shape_2d, full_shape) -> np.ndarray:
    """torch ``xavier_uniform_`` on a (fan_out, fan_in) view, from ``rng``."""
    fan_out, fan_in = shape_2d
    bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return rng.uniform(-bound, bound, size=full_shape).astype(np.float32)


def select_patch_embed_weights(
    weight: torch.Tensor,
    pretrained_bands: Sequence[str],
    model_bands: Sequence[str],
    seed: int = 0,
) -> torch.Tensor:
    """Band surgery on a Conv3d patch-embed weight (D, C, pt, ph, pw):
    bands present in ``pretrained_bands`` are copied into their position in
    ``model_bands``; the others keep a Xavier-uniform draw from a numpy
    Generator seeded with ``seed`` (the JAX package's draw)."""
    w = weight.detach().float().cpu().numpy()
    d = w.shape[0]
    out_shape = (d, len(model_bands)) + w.shape[2:]
    rng = np.random.default_rng(seed)
    out = _xavier_uniform(rng, (d, int(np.prod(out_shape[1:]))), out_shape)
    for index, band in enumerate(model_bands):
        if band in pretrained_bands:
            out[:, index] = w[:, list(pretrained_bands).index(band)]
    return torch.from_numpy(out)


def filter_checkpoint_vit(
    state_dict: Mapping[str, torch.Tensor],
    arch: PrithviArch,
    pretrained_bands: Optional[Sequence[str]] = None,
    model_bands: Optional[Sequence[str]] = None,
) -> Dict[str, torch.Tensor]:
    """A Prithvi(-MAE) state dict cleaned for the ViT encoder: MAE
    ``encoder.`` and ``_timm_module.`` prefixes stripped; decoder weights,
    mask token and the fixed position embedding dropped; blocks past
    ``arch.depth`` dropped; band surgery on the patch embedding."""
    pretrained_bands = list(pretrained_bands or PRETRAINED_BANDS)
    model_bands = list(model_bands or pretrained_bands)
    clean: Dict[str, torch.Tensor] = {}
    for k, v in _unwrap_state_dict(state_dict).items():
        k = k.replace("_timm_module.", "")
        if "pos_embed" in k:
            continue  # regenerated from the shapes
        if "decoder" in k or "_dec" in k or k == "mask_token":
            continue
        if not arch.temporal_encoding and "temporal_embed" in k:
            continue
        if not arch.location_encoding and "location_embed" in k:
            continue
        if k.startswith("encoder."):
            k = k[len("encoder."):]
        k = k.replace("patch_embed.projection.", "patch_embed.proj.")  # terratorch naming
        clean[k] = torch.as_tensor(v)
    clean = {k: v for k, v in clean.items()
             if not k.startswith("blocks.") or int(k.split(".")[1]) < arch.depth}
    proj_key = next((k for k in clean if k.endswith("patch_embed.proj.weight")), None)
    if proj_key is None:
        raise KeyError("Could not find patch embed weight in state_dict.")
    w = clean[proj_key]
    if tuple(w.shape[2:]) == tuple(arch.patch_size) and w.shape[0] == arch.embed_dim:
        clean[proj_key] = select_patch_embed_weights(w, pretrained_bands, model_bands)
    return clean


def load_pretrained_encoder(
    path: str,
    arch: PrithviArch,
    pretrained_bands: Optional[Sequence[str]] = None,
    model_bands: Optional[Sequence[str]] = None,
) -> Dict[str, torch.Tensor]:
    """A pretrained Prithvi(-MAE) checkpoint file as the state dict of the
    port's ``PrithviViT`` (load it into ``model.prithvi_encoder``)."""
    sd = filter_checkpoint_vit(load_torch_file(path), arch, pretrained_bands, model_bands)
    return {k: v.float() for k, v in sd.items()}


def seg_state_dict_from_torch(state_dict: Mapping[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """A reference ``PrithviSeg`` checkpoint's weights (a Lightning
    ``.ckpt``'s ``state_dict``, whose keys carry the module's attribute
    prefix, e.g. ``net.``) under the port's keys, which are the reference's
    without that prefix."""
    sd = _unwrap_state_dict(state_dict)
    anchor = next((k for k in sd if "prithvi_encoder." in k), None)
    if anchor is None:
        raise KeyError("no prithvi_encoder.* weights in the checkpoint")
    prefix = anchor[:anchor.index("prithvi_encoder.")]
    return {k[len(prefix):]: torch.as_tensor(v) for k, v in sd.items() if k.startswith(prefix)}


def export_torch_checkpoint(model_or_state_dict, path: str) -> str:
    """Write a ``PrithviSeg``'s weights (the module or its state dict) as
    the reference's Lightning ``.ckpt`` (``torch.save({"state_dict":
    ...})``), or as an ``.npz`` where ``path`` ends so: float32 on the host,
    keys prefixed ``net.``, BatchNorm's ``num_batches_tracked`` counters
    left out as the JAX export leaves them."""
    sd = (model_or_state_dict.state_dict() if isinstance(model_or_state_dict, torch.nn.Module)
          else model_or_state_dict)
    sd = {"net." + k: v.detach().float().cpu().contiguous() for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}
    if path.endswith(".npz"):
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    else:
        torch.save({"state_dict": sd}, path)
    return path
