"""The port's dropout against the JAX fused-dropout kernel (interpret mode).

The two draw their bits from different generators, so the masks differ.
What is compared is what the TPU kernel's contract fixes: the keep rate
(within 5 binomial standard deviations of 1 − p), kept values equal to
x·f32(1/(1−p)) in x's dtype bit for bit (where both sides keep an element,
the two outputs are equal), dropped values exactly 0, a backward through
the saved mask, one mask per seed, p = 0 as the identity and p ≥ 1
refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instageo_tpu.ops.dropout import _fused_dropout_fwd_impl, fused_dropout as jax_dropout
from instageo_tpu_torch.models.seg import Dropout
from instageo_tpu_torch.ops import dropout as tdrop

torch.set_num_threads(1)

SHAPE = (16, 64, 64)  # 512-divisible, as the JAX kernel needs


def _x(dtype=np.float32, seed=0):
    return np.random.default_rng(seed).standard_normal(SHAPE).astype(dtype)


def _keep_rate_ok(mask: np.ndarray, p: float) -> bool:
    n = mask.size
    return abs(mask.mean() - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n)


@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_contract(p, dtype):
    x = _x()
    xj = jnp.asarray(x).astype(dtype)
    out_j, mask_j = _fused_dropout_fwd_impl(xj, jnp.int32(3), p)
    out_j = np.asarray(out_j.astype(jnp.float32))
    mask_j = np.asarray(mask_j).reshape(SHAPE)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    out, mask = tdrop.fused_dropout_plain(xt, p, torch.Generator().manual_seed(3))
    out, mask = out.float().numpy(), mask.numpy()
    assert _keep_rate_ok(mask, p) and _keep_rate_ok(mask_j, p)
    assert (out[~mask] == 0).all() and (out_j[~mask_j] == 0).all()
    both = mask & mask_j
    assert both.sum() > 0
    np.testing.assert_array_equal(out[both], out_j[both])
    scaled = (xt.float() * np.float32(1.0 / (1.0 - p))).to(xt.dtype).float().numpy()
    np.testing.assert_array_equal(out[mask], scaled[mask])


def test_backward_goes_through_the_saved_mask():
    x, g = _x(seed=1), _x(seed=2)
    p = 0.2
    xt = torch.from_numpy(x).requires_grad_()
    out = tdrop.fused_dropout(xt, p, seed=5)
    out.backward(torch.from_numpy(g))
    _, mask = tdrop.fused_dropout_fwd(torch.from_numpy(x), p, seed=5)
    expected = np.where(mask.numpy(), g * np.float32(1.0 / (1.0 - p)), 0.0)
    np.testing.assert_array_equal(xt.grad.numpy(), expected)
    # JAX's backward has the same form with its own mask.
    seed = jnp.int32(5)
    _, vjp = jax.vjp(lambda a: jax_dropout(a, seed, p), jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(g))
    _, mask_j = _fused_dropout_fwd_impl(jnp.asarray(x), seed, p)
    mask_j = np.asarray(mask_j).reshape(SHAPE)
    np.testing.assert_array_equal(
        np.asarray(gj), np.where(mask_j, g * np.float32(1.0 / (1.0 - p)), 0.0))


def test_one_mask_per_seed_and_counter_stays_zero_on_cpu():
    xt = torch.from_numpy(_x())
    before = tdrop.launches.count
    a = tdrop.fused_dropout_fwd(xt, 0.3, seed=11)
    b = tdrop.fused_dropout_fwd(xt, 0.3, seed=11)
    c = tdrop.fused_dropout_fwd(xt, 0.3, seed=12)
    assert tdrop.launches.count == before
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
    assert not torch.equal(a[1], c[1])


def test_rate_zero_is_identity_and_rate_one_raises():
    x = _x()
    out_j, mask_j = _fused_dropout_fwd_impl(jnp.asarray(x), jnp.int32(0), 0.0)
    out, mask = tdrop.fused_dropout_fwd(torch.from_numpy(x), 0.0, seed=0)
    assert np.asarray(mask_j).all() and mask.all()
    np.testing.assert_array_equal(out.numpy(), x)
    np.testing.assert_array_equal(np.asarray(out_j), x)
    for rate in (1.0, 1.5, -0.1):
        with pytest.raises(ValueError):
            _fused_dropout_fwd_impl(jnp.asarray(x), jnp.int32(0), rate)
        with pytest.raises(ValueError):
            tdrop.fused_dropout_fwd(torch.from_numpy(x), rate, seed=0)


def test_dropout_module_modes():
    x = torch.from_numpy(_x())
    layer = Dropout(0.25)
    assert layer.eval()(x) is x
    layer.train()
    with pytest.raises(RuntimeError):
        layer(x)  # no generator
    layer.generator = torch.Generator().manual_seed(0)
    out = layer(x)
    kept = out != 0
    assert _keep_rate_ok(kept.numpy(), 0.25)
    assert torch.equal(out, tdrop.dropout_apply(x, kept, 0.25))
    assert torch.equal(Dropout(1.0).train()(x), torch.zeros_like(x))
    with pytest.raises(ValueError):
        Dropout(0.1, impl="pallas")
