"""Parity of the port's attention forward with the JAX Pallas kernels.

The JAX side runs the Pallas kernels in interpret mode on the CPU; the port
side runs ``flash_attention_fwd_plain`` (what the wrapper takes for a CPU
tensor). Inputs are float32 from a seeded numpy generator. Tolerance: atol
2e-5, rtol 1e-4, as ``tests/ops_tests/test_attention.py`` holds the kernels
to the XLA reference in float32 (summation order differs).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from instageo_tpu.ops.attention import _flash_fwd_blo, flash_attention_bhld
from instageo_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,h,l,d", [(2, 4, 37, 64), (1, 2, 21, 80)])
def test_merged_matches_jax_blo_kernel(b, h, l, d):
    q, k, v = _qkv((b, h, l, d), seed=l)
    o_ref, lse_ref = _flash_fwd_blo(*(jnp.asarray(x) for x in (q, k, v)), True)
    o, lse = tattn.flash_attention_fwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), "merged")
    assert o.shape == (b, l, h * d) and lse.shape == (b, h, l, 1)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL, rtol=RTOL)


def test_heads_first_matches_jax_bhld():
    q, k, v = _qkv((2, 3, 29, 64), seed=3)
    o_ref = flash_attention_bhld(*(jnp.asarray(x) for x in (q, k, v)), True)
    o = tattn.flash_attention_bhld(*(torch.from_numpy(x) for x in (q, k, v)))
    assert o.shape == (2, 3, 29, 64)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL, rtol=RTOL)


def test_cpu_wrapper_takes_plain_path_without_launching():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 2, 19, 64), seed=5))
    tattn.launches.reset()
    o, lse = tattn.flash_attention_fwd(q, k, v, "merged")
    o_plain, lse_plain = tattn.flash_attention_fwd_plain(q, k, v, "merged")
    assert tattn.launches.count == 0
    assert torch.equal(o, o_plain) and torch.equal(lse, lse_plain)
    with pytest.raises(ValueError):
        tattn.flash_attention_fwd(q, k, v, "bhld")


def test_plain_version_accepts_strided_qkv_views():
    """The model hands the kernel views of its fused qkv output."""
    rng = np.random.default_rng(9)
    b, l, h, d = 2, 13, 3, 16
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3, h, d)).astype(np.float32))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o_view = tattn.flash_attention_blo(q, k, v)
    o_copy = tattn.flash_attention_blo(*(t.contiguous() for t in (q, k, v)))
    assert torch.equal(o_view, o_copy)
