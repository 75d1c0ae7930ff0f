"""The port's dropout against the JAX fused-dropout kernel (interpret mode).

The two draw their bits from different generators (Philox4x32-10 per
(seed, element index) in the port), so the masks differ.
What is compared with JAX is what the TPU kernel's contract fixes: the keep rate
(within 5 binomial standard deviations of 1 − p), kept values equal to
x·f32(1/(1−p)) in x's dtype bit for bit (where both sides keep an element,
the two outputs are equal), dropped values exactly 0, a backward through
the saved mask, one mask per seed, p = 0 as the identity and p ≥ 1
refused. The port's own stream, Philox4x32-10 per (seed, element index),
is held to Random123's known-answer vectors.
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
    out, mask = tdrop.fused_dropout_seeded_plain(xt, p, 3)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seed_slot_gives_the_by_value_mask(dtype):
    """A (buffer, slot) seed reads buffer[slot]: the same 64 bits, so the
    same mask and output bit for bit as the seed by value, through the
    wrapper, the autograd Function and the Dropout module's slots."""
    from instageo_tpu_torch.models.seg import SeedSlots, set_dropout_seeds

    x = torch.from_numpy(_x()).to(dtype)
    seeds = [3, 2**63 - 2, 123456789]
    buf = torch.tensor(seeds, dtype=torch.int64)
    for slot, seed in enumerate(seeds):
        by_value = tdrop.fused_dropout_fwd(x, 0.3, seed)
        held = tdrop.fused_dropout_fwd(x, 0.3, (buf, slot))
        assert torch.equal(held[1], by_value[1]) and torch.equal(held[0], by_value[0])
        assert torch.equal(tdrop.fused_dropout(x, 0.3, (buf, slot)), by_value[0])
    for bad in ((buf.float(), 0), (buf, 3), (buf[None], 0)):
        with pytest.raises(ValueError, match="seed slot"):
            tdrop.fused_dropout_fwd(x, 0.3, bad)
    slots = SeedSlots(2, "cpu")
    slots.buffer.copy_(torch.tensor(seeds[:2]))
    layers = torch.nn.Sequential(Dropout(0.3), Dropout(0.3)).train()
    set_dropout_seeds(layers, slots)
    out = layers(x)
    mask0 = tdrop.fused_dropout_fwd(x, 0.3, seeds[0])[0]
    assert torch.equal(out, tdrop.fused_dropout_fwd(mask0, 0.3, seeds[1])[0])
    assert slots.taken == 2
    with pytest.raises(RuntimeError, match="seed slots"):
        layers(x)


# Random123's known-answer vectors for Philox4x32-10: (counter, key, result).
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,expected", PHILOX_KAT)
def test_plain_philox_matches_known_answers(counter, key, expected):
    out = tdrop.philox4x32_10(torch.tensor([counter]), torch.tensor([key]))
    assert tuple(int(w) for w in out[0]) == expected


def test_element_takes_word_of_its_counter():
    """Element i takes word i % 4 of counter i / 4 = (lo, hi, 0, 0) under key
    seed = (lo, hi), also where the counter's high word is not zero."""
    seed = (7 << 32) + 3
    key = torch.tensor([[3, 7]])
    for start in (0, 5, (1 << 34) + 6):
        bits = tdrop.philox_bits(11, seed, start=start)
        for i in range(start, start + 11):
            grp = i // 4
            words = tdrop.philox4x32_10(
                torch.tensor([[grp & 0xFFFFFFFF, grp >> 32, 0, 0]]), key)[0]
            assert int(bits[i - start]) == int(words[i % 4]), (start, i)
    assert tdrop.philox_bits(8, seed, start=1 << 34)[0] != tdrop.philox_bits(8, seed)[0]


def test_cpu_mask_depends_on_seed_and_index_only():
    """One mask per seed whatever the shape or dtype of the tensor, and
    ``impl="plain"`` draws the same stream as the wrapper."""
    x = torch.from_numpy(_x())
    _, mask = tdrop.fused_dropout_fwd(x, 0.3, seed=21)
    for shape in ((x.numel(),), (4, x.numel() // 4), (2, 8, 64, 64)):
        _, m = tdrop.fused_dropout_fwd(x.reshape(shape), 0.3, seed=21)
        assert torch.equal(m.reshape(-1), mask.reshape(-1))
    _, m16 = tdrop.fused_dropout_fwd(x.to(torch.bfloat16), 0.3, seed=21)
    assert torch.equal(m16, mask)
    # Shorter tensors take the first elements of the same stream.
    _, head = tdrop.fused_dropout_fwd(x.reshape(-1)[:1001], 0.3, seed=21)
    assert torch.equal(head, mask.reshape(-1)[:1001])
    out = tdrop.fused_dropout(x, 0.3, seed=21, impl="plain")
    assert torch.equal(out, tdrop.dropout_apply(x, mask, 0.3))


def test_plain_stream_threshold_and_keep_rate():
    bits = tdrop.philox_bits(1 << 16, seed=5)
    assert int(bits.min()) >= 0 and int(bits.max()) < 1 << 32
    for p in (0.1, 0.5):
        assert _keep_rate_ok((bits >= tdrop.threshold(p)).numpy(), p)
