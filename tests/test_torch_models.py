"""Parity of the port's PrithviSeg with the JAX model on the same weights.

The JAX tiny model (depth 2, 32 px, 6 bands, 3 classes) gets seeded numpy
variables (every bias and BatchNorm statistic non-trivial, so each carries
information through the weight bridge), and both models run the same
float32 inputs. Bounds: encoder tokens
(the head's feature map) 2e-4 abs, logits 5e-4 abs — float32 with two
LayerNorm variance formulas and another summation order across two blocks
and four convolution stages.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from instageo_tpu.models.checkpoint import seg_variables_to_torch
from instageo_tpu.models.registry import get_arch as jax_get_arch
from instageo_tpu.models.seg import create_prithvi_seg as jax_create_prithvi_seg
from instageo_tpu_torch.models.checkpoint import seg_state_dict_from_jax
from instageo_tpu_torch.models.registry import get_arch
from instageo_tpu_torch.models.seg import create_prithvi_seg
from tests.torch_parity import random_seg_variables

torch.set_num_threads(1)

TOKENS_ATOL = 2e-4
LOGITS_ATOL = 5e-4
KW = dict(depth=2, image_size=32, num_bands=6, num_classes=3)


@pytest.fixture(scope="module")
def jax_models():
    """T -> (JAX model, seeded numpy variables), built once per module."""
    out = {}
    for t in (1, 2):
        model = jax_create_prithvi_seg("prithvi_eo_tiny", temporal_step=t, **KW)
        out[t] = (model, random_seg_variables(model, t, 32, seed=t))
    return out


def _port_model(variables, temporal_step):
    arch = get_arch("prithvi_eo_tiny", in_chans=6, num_frames=temporal_step,
                    img_size=32, depth=2)
    model = create_prithvi_seg("prithvi_eo_tiny", temporal_step=temporal_step,
                               device="cpu", **KW)
    model.load_state_dict(seg_state_dict_from_jax(variables, arch), strict=True)
    return model


@pytest.mark.parametrize("temporal_step,size,jax_attn", [
    (1, 32, "xla"),
    (1, 48, "xla"),  # 3x3 grid against the arch's 2x2: bicubic pos-embed
    (2, 32, "pallas"),  # the JAX Pallas kernel in interpret mode as reference
])
def test_seg_forward_matches_jax(jax_models, temporal_step, size, jax_attn):
    model, variables = jax_models[temporal_step]
    if jax_attn == "pallas":
        model = jax_create_prithvi_seg("prithvi_eo_tiny", temporal_step=temporal_step,
                                       attn_impl="pallas", attn_interpret=True, **KW)
    rng = np.random.default_rng(100 + size + temporal_step)
    x = rng.standard_normal((2, 6, temporal_step, size, size)).astype(np.float32)
    logits_ref, feats_ref = model.apply(variables, jnp.asarray(x), return_features=True)

    port = _port_model(variables, temporal_step)
    with torch.no_grad():
        logits, feats = port(torch.from_numpy(x), return_features=True)
    assert logits.shape == (2, 3, size, size) and logits.dtype == torch.float32
    np.testing.assert_allclose(feats.numpy(), np.asarray(feats_ref), rtol=0,
                               atol=TOKENS_ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), rtol=0,
                               atol=LOGITS_ATOL)


@pytest.mark.parametrize("temporal_step", [1, 2])
def test_state_dict_bridge_matches_jax_export(jax_models, temporal_step):
    _, variables = jax_models[temporal_step]
    kw = dict(in_chans=6, num_frames=temporal_step, img_size=32, depth=2)
    ours = seg_state_dict_from_jax(variables, get_arch("prithvi_eo_tiny", **kw))
    ref = seg_variables_to_torch(variables, jax_get_arch("prithvi_eo_tiny", **kw),
                                 prefix="")
    assert list(sorted(ours)) == list(sorted(ref))
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)


def test_channels_last_and_coords_encoding_guard(jax_models):
    _, variables = jax_models[1]
    port = _port_model(variables, 1)
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, 6, 1, 32, 32)).astype(np.float32))
    with torch.no_grad():
        nchw = port(x)
        nhwc = port(x, channels_last=True)
    assert torch.equal(nchw.permute(0, 2, 3, 1), nhwc)
    with pytest.raises(NotImplementedError):
        create_prithvi_seg("prithvi_eo_v2_300_tl", depth=1, image_size=32, device="cpu")
