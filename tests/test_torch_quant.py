"""The port's dynamic int8 (W8A8) serving path against the JAX package's.

``ops/quant.py``: the same seeded float32 inputs through both packages'
``quantize_symmetric`` and ``int8_matmul``: int8 values and scales equal,
outputs within 1e-6 relative (the same float32 operations in the same
order; the int32 products are exact). The quantized tiny segmentation
model with bridged weights against the JAX ``quant="int8"`` model: in
float32 (the port's "xla" attention route), encoder tokens within 2e-3 abs
(a value within float32 rounding of a half step rounds the other way in
one package: one int8 step of one activation, ~1e-3 here) and logits
within the float32 model test's 5e-4; in bf16 (the kernel route, its plain
version here), logits within 0.05 × max |logit| (``chip_smoke.py``'s
kernel-vs-plain bound) and the same class on every pixel. Then the export
artifact, the factory and the Trainer's refusal.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from instageo_tpu.models.seg import create_prithvi_seg as jax_create_prithvi_seg
from instageo_tpu.ops.quant import int8_matmul as jax_int8_matmul
from instageo_tpu.ops.quant import quantize_symmetric as jax_quantize_symmetric
from instageo_tpu_torch.configs.config import load_config
from instageo_tpu_torch.models.checkpoint import seg_state_dict_from_jax
from instageo_tpu_torch.models.registry import get_arch
from instageo_tpu_torch.models.seg import create_prithvi_seg
from instageo_tpu_torch.ops.quant import QuantLinear, int8_matmul, quantize_symmetric
from tests.torch_parity import random_seg_variables

torch.set_num_threads(1)

KW = dict(depth=2, image_size=32, num_bands=6, num_classes=3)
TOKENS_ATOL = 2e-3
LOGITS_ATOL = 5e-4
BF16_LOGIT_TOL = 0.05


@pytest.mark.parametrize("shape,scale", [((4, 10, 64), 3.0), ((16, 96), 1e-3),
                                         ((3, 8), 0.0)])
def test_quantize_and_int8_matmul_equal_jax(shape, scale):
    rng = np.random.default_rng(len(shape) + int(scale * 10))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    q_ref, s_ref = jax_quantize_symmetric(jnp.asarray(x))
    q, s = quantize_symmetric(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))

    n = 48
    kernel = (rng.standard_normal((shape[-1], n)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)))
    weight = torch.from_numpy(np.ascontiguousarray(kernel.T))
    got = int8_matmul(torch.from_numpy(x), weight, torch.from_numpy(bias))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    # The quantized weight computed once gives the same product.
    layer = QuantLinear(shape[-1], n)
    with torch.no_grad():
        layer.weight.copy_(weight)
        layer.bias.copy_(torch.from_numpy(bias))
        assert torch.equal(layer(torch.from_numpy(x)), got)
        layer.weight.mul_(2.0)  # a new weight: the cached quantization is redone
        assert torch.equal(layer(torch.from_numpy(x)),
                           int8_matmul(torch.from_numpy(x), 2.0 * weight,
                                       torch.from_numpy(bias)))


def _models(dtype, jax_dtype):
    jax_model = jax_create_prithvi_seg("prithvi_eo_tiny", temporal_step=1, quant="int8",
                                       dtype=jax_dtype, **KW)
    variables = random_seg_variables(jax_model, 1, 32, seed=1)
    arch = get_arch("prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32, depth=2)
    port = create_prithvi_seg("prithvi_eo_tiny", temporal_step=1, quant="int8", dtype=dtype,
                              attn_impl="xla" if dtype == torch.float32 else "kernel",
                              device="cpu", **KW)
    port.load_state_dict(seg_state_dict_from_jax(variables, arch), strict=True)
    return jax_model, variables, port


def test_quant_seg_model_matches_jax_f32():
    jax_model, variables, port = _models(torch.float32, jnp.float32)
    assert isinstance(port.prithvi_encoder.blocks[0].mlp.fc1, QuantLinear)
    assert port.prithvi_encoder.blocks[0].attn.qkv.weight.dtype == torch.float32
    x = np.random.default_rng(2).standard_normal((2, 6, 1, 32, 32)).astype(np.float32)
    logits_ref, feats_ref = jax_model.apply(variables, jnp.asarray(x), return_features=True)
    with torch.no_grad():
        logits, feats = port(torch.from_numpy(x), return_features=True)
    np.testing.assert_allclose(feats.numpy(), np.asarray(feats_ref), rtol=0, atol=TOKENS_ATOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_ref), rtol=0,
                               atol=LOGITS_ATOL)


def test_quant_seg_model_matches_jax_bf16():
    jax_model, variables, port = _models(torch.bfloat16, jnp.bfloat16)
    x = np.random.default_rng(3).standard_normal((2, 6, 1, 32, 32)).astype(np.float32)
    ref = np.asarray(jax_model.apply(variables, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).float().numpy()
    assert np.abs(got - ref).max() <= BF16_LOGIT_TOL * np.abs(ref).max()
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def test_quant_export_round_trip(tmp_path):
    """The artifact of a quantized model holds the int8 products
    (``aten._int_mm``) and gives the live model's class ids."""
    from instageo_tpu_torch.serve.export import export_predict, load_predict

    _, _, port = _models(torch.bfloat16, jnp.bfloat16)
    path = str(tmp_path / "quant.pt2")
    export_predict(port, path, num_bands=6, img_size=32)
    program = torch.export.load(path)
    int_mm = [n for n in program.graph.nodes if "_int_mm" in str(n.target)]
    assert len(int_mm) == 4 * 2  # qkv, proj, fc1, fc2 per block
    predict, _ = load_predict(path)
    x = np.random.default_rng(4).standard_normal((3, 6, 1, 32, 32)).astype(np.float32)
    with torch.no_grad():
        live = port(torch.from_numpy(x)).argmax(1).to(torch.int8)
    assert torch.equal(predict(port.state_dict(), x), live)


def _cfg(**over):
    overrides = {"model.model_name": "prithvi_eo_tiny", "model.depth": 2,
                 "dataloader.img_size": 32, "dataloader.bands": [0, 1, 2, 3, 4, 5],
                 "dataloader.mean": [0.0] * 6, "dataloader.std": [1.0] * 6,
                 "model.num_classes": 3, "train.class_weights": [1.0, 1.0, 1.0],
                 "train.batch_size": 2, "tpu.quant": "int8"}
    overrides.update(over)
    return load_config("config", overrides=overrides)


def test_factory_honours_quant():
    from instageo_tpu_torch.train.factory import build_model

    model = build_model(_cfg(), device="cpu")
    assert model.quant == "int8"
    assert all(isinstance(b.attn.proj, QuantLinear) for b in model.prithvi_encoder.blocks)
    with pytest.raises(ValueError, match="tpu.quant"):
        build_model(_cfg(**{"tpu.quant": "int4"}), device="cpu")


def test_trainer_refuses_quant_training_but_evaluates():
    from instageo_tpu_torch.train.factory import build_model
    from instageo_tpu_torch.train.trainer import Trainer

    cfg = _cfg()
    model = build_model(cfg, device="cpu", training=True)
    trainer = Trainer(cfg, model, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 1, 32, 32)).astype(np.float32)
    y = rng.integers(0, 3, (2, 32, 32)).astype(np.int64)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="inference-only"):
        trainer.train_step(torch.from_numpy(x), torch.from_numpy(y), gen)
    with pytest.raises(ValueError, match="inference-only"):
        trainer.run_train_epoch(iter([(x, y)]), gen, 2)
    with pytest.raises(ValueError, match="inference-only"):
        trainer.fit(lambda: iter([(x, y)]), lambda: iter([(x, y)]))
    assert trainer.step == 0
    metrics = trainer.run_eval_epoch(iter([(x, y)]), 2, "val")
    assert np.isfinite(metrics["val_loss"])
