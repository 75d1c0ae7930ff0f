"""The model variants the JAX package builds, in the port, on the same weights.

* the fast head (``head_impl="fast"``): three 3×3 stages with a 128-channel
  floor, the classifier at half resolution and a float32 bilinear resize of
  the logits, at T=1 and T=3 on the tiny model (D·T = 256 and 768, so the
  floor binds at T=1);
* the resize alone against ``jax.image.resize(..., "bilinear")`` at the
  heads' scales, 2 (p=16) and 1.75 (p=14), square and non-square;
* ``prithvi_eo_v2_300_tl`` (depth 1): the temporal and location encoders
  with their learnable scales, without coords and with them, in float32
  and, with coords, in bf16 compute;
* the GELU lowerings ``tanh`` and ``bf16``;
* a stacked-layout (``tpu.block_layout: scan``) JAX tree through the weight
  bridge, which must give the loop-layout tree's state dict;
* one fast-head train step (dropout off) against the JAX step;
* the factory builds every one of them from a config.

Bounds: fast-head logits 1e-4 abs (float32, three convolution stages where
the torch head has four, against its 5e-4); resize 1e-6 abs; ``_tl`` logits
5e-4 abs (``tests/test_torch_models.py``'s bound: a 1024-wide block);
the bf16 MLP 2e-2 relative (bf16 rounding of the GELU input and output),
and the bf16 ``_tl`` logits 2e-2 in relative norm;
train step as ``tests/test_torch_train.py``: loss 1e-5 relative, gradients
1e-4 relative + 1e-6 in norm.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instageo_tpu.models import prithvi as jax_prithvi
from instageo_tpu.models.registry import PRETRAINED_WEIGHTS as JAX_PRETRAINED_WEIGHTS
from instageo_tpu.models.seg import TPUDropout
from instageo_tpu.models.seg import create_prithvi_seg as jax_create_prithvi_seg
from instageo_tpu.train import losses as jl
from instageo_tpu_torch.configs.config import load_config
from instageo_tpu_torch.models import prithvi as port_prithvi
from instageo_tpu_torch.models.checkpoint import seg_state_dict_from_jax
from instageo_tpu_torch.models.registry import PRETRAINED_WEIGHTS, get_arch
from instageo_tpu_torch.models.seg import (
    create_prithvi_seg,
    fast_head_dims,
    resize_logits,
    train_mode,
)
from instageo_tpu_torch.train import factory
from instageo_tpu_torch.train.trainer import Trainer
from tests.torch_parity import random_seg_variables

torch.set_num_threads(1)

FAST_ATOL = 1e-4
RESIZE_ATOL = 1e-6
LOGITS_ATOL = 5e-4
BF16_RTOL = 2e-2
STEP_LOSS_RTOL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
KW = dict(depth=2, image_size=32, num_bands=6, num_classes=3)


def _port(variant, variables, t, size=32, depth=2, **kw):
    arch = get_arch(variant, in_chans=6, num_frames=t, img_size=size, depth=depth)
    model = create_prithvi_seg(variant, temporal_step=t, depth=depth, image_size=size,
                               num_bands=6, num_classes=3, device="cpu", **kw)
    model.load_state_dict(seg_state_dict_from_jax(variables, arch), strict=True)
    return model


def _x(t, seed, size=32, b=2):
    return np.random.default_rng(seed).standard_normal((b, 6, t, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def fast_models():
    """T -> (JAX fast-head model, seeded numpy variables)."""
    out = {}
    for t in (1, 3):
        model = jax_create_prithvi_seg("prithvi_eo_tiny", temporal_step=t, head_impl="fast",
                                       **KW)
        out[t] = (model, random_seg_variables(model, t, 32, seed=30 + t))
    return out


@pytest.mark.parametrize("temporal_step", [1, 3])
def test_fast_head_forward_matches_jax(fast_models, temporal_step):
    model, variables = fast_models[temporal_step]
    x = _x(temporal_step, 40 + temporal_step)
    ref = np.asarray(model.apply(variables, jnp.asarray(x)))
    port = _port("prithvi_eo_tiny", variables, temporal_step, head_impl="fast")
    assert fast_head_dims(256 * temporal_step) == (
        (256, 128, 128, 128) if temporal_step == 1 else (768, 384, 192, 128))
    assert port.fast_head_conv.in_channels == 128
    with torch.no_grad():
        logits = port(torch.from_numpy(x))
    assert logits.shape == (2, 3, 32, 32) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=FAST_ATOL)


def test_fast_checkpoint_fails_a_torch_head_load(fast_models):
    """The fast head's names are not the torch head's: a checkpoint of one
    head loaded strictly into the other raises."""
    _, variables = fast_models[1]
    arch = get_arch("prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32, depth=2)
    fast_sd = seg_state_dict_from_jax(variables, arch)
    assert {k.split(".")[0] for k in fast_sd} == {
        "prithvi_encoder", "fast_up_0", "fast_up_1", "fast_up_2", "fast_head_conv"}
    torch_head = create_prithvi_seg("prithvi_eo_tiny", device="cpu", **KW)
    with pytest.raises(RuntimeError, match="fast_up_0"):
        torch_head.load_state_dict(fast_sd, strict=True)
    fast = create_prithvi_seg("prithvi_eo_tiny", head_impl="fast", device="cpu", **KW)
    with pytest.raises(RuntimeError, match="segmentation_head"):
        fast.load_state_dict(torch_head.state_dict(), strict=True)


@pytest.mark.parametrize("src,dst", [((16, 16), (32, 32)),   # scale 2 (p=16)
                                     ((8, 8), (14, 14)),     # scale 1.75 (p=14)
                                     ((64, 64), (112, 112)),  # scale 1.75
                                     ((16, 8), (32, 14))])   # non-square: 2 by 1.75
def test_resize_matches_jax_image_resize(src, dst):
    logits = np.random.default_rng(sum(src)).standard_normal((2, 3) + src).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(logits.transpose(0, 2, 3, 1)), (2,) + dst + (3,),
                           method="bilinear")
    ours = resize_logits(torch.from_numpy(logits), dst)
    assert ours.shape == (2, 3) + dst and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref).transpose(0, 3, 1, 2),
                               rtol=0, atol=RESIZE_ATOL)


@pytest.fixture(scope="module")
def tl_model():
    model = jax_create_prithvi_seg("prithvi_eo_v2_300_tl", temporal_step=2, depth=1,
                                   image_size=32, num_bands=6, num_classes=3,
                                   head_impl="fast")
    return model, random_seg_variables(model, 2, 32, seed=50)


def test_tl_encoders_match_jax(tl_model):
    """Without coords the encoders add nothing; with them, the per-frame
    temporal and the location embeddings times their learnable scales (drawn
    away from 0.1, so a missed scale shows)."""
    model, variables = tl_model
    enc = variables["params"]["prithvi_encoder"]
    assert set(enc["temporal_embed_enc"]) == {"scale"} and set(enc["location_embed_enc"]) == {
        "scale"}
    port = _port("prithvi_eo_v2_300_tl", variables, 2, depth=1, head_impl="fast")
    x = _x(2, 51)
    temporal = np.array([[[2019.0, 32.0], [2020.0, 200.0]],
                         [[2021.0, 150.0], [2021.0, 365.0]]], np.float32)
    location = np.array([[45.5, -93.25], [-12.0, 130.0]], np.float32)
    ref_plain = np.asarray(model.apply(variables, jnp.asarray(x)))
    ref_coords = np.asarray(model.apply(variables, jnp.asarray(x),
                                        temporal_coords=jnp.asarray(temporal),
                                        location_coords=jnp.asarray(location)))
    with torch.no_grad():
        plain = port(torch.from_numpy(x))
        coords = port(torch.from_numpy(x), temporal_coords=torch.from_numpy(temporal),
                      location_coords=torch.from_numpy(location))
    np.testing.assert_allclose(plain.numpy(), ref_plain, rtol=0, atol=LOGITS_ATOL)
    np.testing.assert_allclose(coords.numpy(), ref_coords, rtol=0, atol=LOGITS_ATOL)
    assert np.abs(ref_coords - ref_plain).max() > 100 * LOGITS_ATOL


def test_tl_forward_in_bf16_matches_jax(tl_model):
    """The ``_tl`` model with coords in bf16 compute against the JAX model in
    bf16: the frame's embedding broadcast over its tokens, in float32 and
    then cast, as JAX adds its repeated rows. The coords move the logits
    by more than the bf16 gap, so a model that drops them fails."""
    _, variables = tl_model
    model = jax_create_prithvi_seg("prithvi_eo_v2_300_tl", temporal_step=2, depth=1,
                                   image_size=32, num_bands=6, num_classes=3,
                                   head_impl="fast", dtype=jnp.bfloat16)
    port = _port("prithvi_eo_v2_300_tl", variables, 2, depth=1, head_impl="fast",
                 dtype=torch.bfloat16)
    x = _x(2, 52)
    temporal = np.array([[[2018.0, 61.0], [2018.0, 299.0]],
                         [[2023.0, 100.0], [2023.0, 250.0]]], np.float32)
    location = np.array([[25.5, -124.0], [48.75, -67.5]], np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x),
                                 temporal_coords=jnp.asarray(temporal),
                                 location_coords=jnp.asarray(location))).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x), temporal_coords=torch.from_numpy(temporal),
                   location_coords=torch.from_numpy(location)).float().numpy()
        bare = port(torch.from_numpy(x)).float().numpy()
    gap = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert gap <= BF16_RTOL
    assert np.linalg.norm(bare - ref) / np.linalg.norm(ref) > 5 * gap


def test_tl_embeddings_match_jax():
    """The encoders alone: float32 embeddings equal the JAX ones within
    float32 rounding of the sin/cos of year-sized arguments."""
    temporal = np.array([[[2019.0, 32.0], [2020.0, 200.0], [2022.0, 5.0]]], np.float32)
    location = np.array([[45.5, -93.25], [-12.0, 130.0]], np.float32)
    for trainable in (False, True):
        t_ref = jax_prithvi.TemporalEncoder(64, trainable)
        t_vars = t_ref.init(jax.random.PRNGKey(0), jnp.asarray(temporal))
        ref = np.asarray(t_ref.apply(t_vars, jnp.asarray(temporal), 5))
        ours = port_prithvi.TemporalEncoder(64, trainable)
        if trainable:
            with torch.no_grad():
                ours.scale.fill_(0.1)
        got = ours(torch.from_numpy(temporal)).detach()
        assert got.shape == (1, 3, 64)
        # JAX repeats a frame's row for its tokens; the port broadcasts it.
        np.testing.assert_allclose(np.repeat(got.numpy(), 5, axis=1), ref, rtol=0, atol=1e-6)
        l_ref = jax_prithvi.LocationEncoder(64, trainable)
        l_vars = l_ref.init(jax.random.PRNGKey(0), jnp.asarray(location))
        ref = np.asarray(l_ref.apply(l_vars, jnp.asarray(location)))
        ours = port_prithvi.LocationEncoder(64, trainable)
        if trainable:
            with torch.no_grad():
                ours.scale.fill_(0.1)
        np.testing.assert_allclose(ours(torch.from_numpy(location)).detach().numpy(), ref,
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("gelu", ["tanh", "bf16"])
def test_gelu_lowerings_match_jax(gelu):
    """The whole tiny model in float32 with the lowering, and its MLP alone
    in bf16 compute, against the JAX ones."""
    model = jax_create_prithvi_seg("prithvi_eo_tiny", temporal_step=1, gelu=gelu, **KW)
    variables = random_seg_variables(model, 1, 32, seed=60)
    x = _x(1, 61)
    ref = np.asarray(model.apply(variables, jnp.asarray(x)))
    port = _port("prithvi_eo_tiny", variables, 1, gelu=gelu)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=LOGITS_ATOL)

    rng = np.random.default_rng(62)
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    mlp = jax_prithvi.Mlp(64, 32, dtype=jnp.bfloat16, gelu=gelu)
    mvars = mlp.init(jax.random.PRNGKey(1), jnp.asarray(h, jnp.bfloat16))
    ref = np.asarray(mlp.apply(mvars, jnp.asarray(h, jnp.bfloat16)).astype(jnp.float32))
    ours = port_prithvi.Mlp(32, 64, dtype=torch.bfloat16, gelu=gelu)
    p = jax.tree.map(np.asarray, mvars["params"])
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            layer = getattr(ours, name)
            layer.weight.copy_(torch.from_numpy(p[name]["kernel"].T.copy()))
            layer.bias.copy_(torch.from_numpy(p[name]["bias"]))
        got = ours(torch.from_numpy(h).to(torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=BF16_RTOL, atol=BF16_RTOL * np.abs(ref).max())


def test_stacked_tree_bridges_as_the_loop_tree(fast_models):
    """A scan-layout tree (the JAX package's ``stack_block_params``) gives
    the loop-layout tree's state dict bit for bit."""
    model, variables = fast_models[3]
    enc = variables["params"]["prithvi_encoder"]
    stacked_enc = jax.tree.map(np.asarray, jax_prithvi.stack_block_params(enc, 2))
    assert "blocks" in stacked_enc and "blocks_0" not in stacked_enc
    stacked = {"params": {**variables["params"], "prithvi_encoder": stacked_enc},
               "batch_stats": variables["batch_stats"]}
    arch = get_arch("prithvi_eo_tiny", in_chans=6, num_frames=3, img_size=32, depth=2)
    loop_sd = seg_state_dict_from_jax(variables, arch)
    stacked_sd = seg_state_dict_from_jax(stacked, arch)
    assert list(stacked_sd) == list(loop_sd)
    for key, value in loop_sd.items():
        assert torch.equal(stacked_sd[key], value), key
    # The JAX scan model reads its stacked tree as the loop model reads its own.
    scan = jax_create_prithvi_seg("prithvi_eo_tiny", temporal_step=3, head_impl="fast",
                                  block_layout="scan", **KW)
    x = _x(3, 70)
    np.testing.assert_allclose(np.asarray(scan.apply(stacked, jnp.asarray(x))),
                               np.asarray(model.apply(variables, jnp.asarray(x))),
                               rtol=0, atol=FAST_ATOL)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, TPUDropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def test_fast_head_train_step_matches_jax(fast_models):
    """Loss and every gradient of one train step (dropout off, BatchNorm on
    batch statistics) at T=1, float32."""
    model, variables = fast_models[1]
    rng = np.random.default_rng(80)
    x = rng.standard_normal((2, 6, 1, 32, 32)).astype(np.float32)
    y = rng.integers(0, 3, (2, 32, 32)).astype(np.int32)
    y[:, :3] = -1
    weights = [0.5, 1.0, 2.0]

    def loss_fn(params):
        with fnn.intercept_methods(_no_dropout):
            logits, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jl.masked_cross_entropy(logits, jnp.asarray(y), -1, weights)

    params = jax.tree.map(jnp.asarray, variables["params"])
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(params)
    arch = get_arch("prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32, depth=2)
    grads_ref = seg_state_dict_from_jax({"params": jax.tree.map(np.asarray, grads_ref)}, arch)

    port = create_prithvi_seg("prithvi_eo_tiny", temporal_step=1, head_impl="fast",
                              param_dtype=torch.float32, device="cpu", **KW)
    port.load_state_dict(seg_state_dict_from_jax(variables, arch), strict=True)
    cfg = {"train": {"learning_rate": 1e-3, "weight_decay": 0.01, "ignore_index": -1,
                     "class_weights": weights},
           "model": {"num_classes": 3}}
    trainer = Trainer(cfg, port, device="cpu")
    train_mode(port, torch.Generator(), dropout_rate=0.0)
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, name=name: grads.__setitem__(name, p.grad.clone()))
        for name, p in port.named_parameters()]
    loss = trainer.train_step(torch.from_numpy(x), torch.from_numpy(y).long(),
                              torch.Generator())
    for h in hooks:
        h.remove()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=STEP_LOSS_RTOL)
    assert set(grads) == {n for n, _ in port.named_parameters()}
    for name, g in grads.items():
        diff = (g - grads_ref[name]).norm().item()
        assert diff <= GRAD_REL * grads_ref[name].norm().item() + GRAD_ABS, name


@pytest.mark.parametrize("overrides", [
    {"model.head_impl": "fast"},
    {"model.model_name": "prithvi_eo_v2_300_tl", "model.depth": 1},
    {"model.model_name": "prithvi_eo_v2_600_tl", "model.depth": 1, "dataloader.img_size": 56},
    {"tpu.gelu": "tanh"},
    {"tpu.gelu": "bf16"},
    {"tpu.block_layout": "scan"},
])
def test_factory_builds_every_variant(overrides):
    over = {"model.model_name": "prithvi_eo_tiny", "model.depth": 2, "model.num_classes": 3,
            "dataloader.img_size": 32, "tpu.precision": "f32", **overrides}
    model = factory.build_model(load_config("config", overrides=over), device="cpu")
    size = over["dataloader.img_size"]
    with torch.no_grad():
        out = model(torch.zeros(1, 6, 1, size, size))
    assert out.shape[:2] == (1, 3) and torch.isfinite(out).all()
    if "model.head_impl" in overrides:
        assert model.head_impl == "fast" and out.shape == (1, 3, size, size)
    gelu = overrides.get("tpu.gelu", "exact")
    assert model.prithvi_encoder.blocks[0].mlp.gelu == gelu
    # Without tpu.pp the pipeline layout is the loop's blocks, as the JAX
    # model's is the scan's without a pipe mesh; remat builds the same.
    for extra in ({"tpu.block_layout": "pipeline"}, {"tpu.remat": True}):
        other = factory.build_model(load_config("config", overrides={**over, **extra}),
                                    device="cpu")
        with torch.no_grad():
            torch.testing.assert_close(other(torch.zeros(1, 6, 1, size, size)), out)


def test_pretrained_weights_table_is_the_jax_one():
    assert PRETRAINED_WEIGHTS == JAX_PRETRAINED_WEIGHTS
