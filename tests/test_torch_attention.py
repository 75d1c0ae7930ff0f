"""Parity of the port's attention with the JAX Pallas kernels.

The JAX side runs the Pallas kernels in interpret mode on the CPU; the port
side runs ``flash_attention_fwd_plain`` and ``flash_attention_bwd_plain``
(what the wrappers take for a CPU tensor). Inputs are float32 from a seeded
numpy generator. Tolerance: forward atol 2e-5, rtol 1e-4, as
``tests/ops_tests/test_attention.py`` holds the kernels to the XLA reference
in float32 (summation order differs); backward atol = rtol = 2e-4, as that
file holds the Pallas gradients.
"""

import jax
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from instageo_tpu.ops.attention import (
    _flash_bloq,
    _flash_fwd_blo,
    _merged_grouping,
    _qblock_plan,
    flash_attention_bhld,
    flash_attention_blo,
)
from instageo_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4
GRAD_TOL = 2e-4


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


@pytest.mark.parametrize("d", tattn.SUPPORTED_HEAD_DIMS)
def test_forward_route_by_head_dim(d):
    """Every head dim of the model registry (64, 80) takes the wgmma
    kernel; the other supported ones the mma.sync kernel."""
    assert tattn.fwd_route(d) == ("wgmma" if d in (64, 80) else "mma_sync")


def test_forward_route_refuses_unsupported_head_dims():
    for d in (8, 72, 144):
        with pytest.raises(ValueError):
            tattn.fwd_route(d)
    with pytest.raises(ValueError):
        tattn.tma_boxes(128)


# The boxes' fields of a description: how many, then (first column,
# columns, swizzle bytes) of each, room for two.
TMA_BOXES = {64: (1, 0, 64, 128, 0, 0, 0), 80: (2, 0, 64, 128, 64, 16, 32)}


@pytest.mark.parametrize("d", [64, 80])
def test_tma_description_of_contiguous_operand(d):
    b, h, l = 3, 5, 589
    x = torch.zeros((b, h, l, d), dtype=torch.bfloat16)
    row = 2 * d
    assert tattn.tma_description(x) == (d, l, h, b, row, l * row, h * l * row) + TMA_BOXES[d]


@pytest.mark.parametrize("d", [64, 80])
def test_tma_description_of_qkv_views(d):
    """The model's q/k/v are views of one (B, L, 3, H, Dh) buffer: row
    stride 3·H·Dh, head stride Dh, batch stride L·3·H·Dh elements, and the
    base of k and v Dh·H elements past the last."""
    b, l, h = 2, 197, 12
    qkv = torch.zeros((b, l, 3, h, d), dtype=torch.bfloat16)
    views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    descs = [tattn.tma_description(x) for x in views]
    assert all(desc == descs[0] for desc in descs)
    assert descs[0][:7] == (d, l, h, b, 2 * 3 * h * d, 2 * d, 2 * l * 3 * h * d)
    assert descs[0][7:] == TMA_BOXES[d]
    assert [x.data_ptr() - qkv.data_ptr() for x in views] == [0, 2 * h * d, 4 * h * d]
    # Every stride TMA is given is a multiple of 16 bytes, also for dims of size 1.
    one = tattn.tma_description(qkv[:1, :1, 0].transpose(1, 2)[:, :1])
    assert one[1:4] == (1, 1, 1) and all(s % 16 == 0 for s in one[4:7])


def test_plain_version_accepts_strided_qkv_views():
    """The model hands the kernel views of its fused qkv output."""
    rng = np.random.default_rng(9)
    b, l, h, d = 2, 13, 3, 16
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3, h, d)).astype(np.float32))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o_view = tattn.flash_attention_blo(q, k, v)
    o_copy = tattn.flash_attention_blo(*(t.contiguous() for t in (q, k, v)))
    assert torch.equal(o_view, o_copy)


def _port_grads(entry, q, k, v, do):
    """Gradients of ``entry`` through ``FlashAttention`` for cotangent ``do``."""
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = entry(*leaves)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def _jax_grads(fn, q, k, v, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _assert_grads_close(grads, refs):
    for name, g, ref in zip("qkv", grads, refs):
        np.testing.assert_allclose(g, ref, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("b,h,l,d", [(2, 4, 37, 64), (1, 2, 21, 80)])
def test_merged_backward_matches_jax_blo_kernel(b, h, l, d):
    """The merged entry against ``_attn_bwd_kernel_blo`` (TPU kernel #3)
    with a non-uniform merged cotangent."""
    assert _merged_grouping(h, l, d) is not None  # JAX takes the merged kernels
    q, k, v = _qkv((b, h, l, d), seed=l + 1)
    do = np.random.default_rng(l).standard_normal((b, l, h * d)).astype(np.float32)
    out_ref, refs = _jax_grads(lambda *a: flash_attention_blo(*a, interpret=True),
                               q, k, v, do)
    bwd0 = tattn.bwd_launches.count
    out, grads = _port_grads(tattn.flash_attention_blo, q, k, v, do)
    assert tattn.bwd_launches.count == bwd0  # CPU tensors: the plain backward
    np.testing.assert_allclose(out, out_ref, atol=ATOL, rtol=RTOL)
    _assert_grads_close(grads, refs)


def test_heads_first_backward_matches_jax_bhld_kernel():
    """The heads-first entry against ``_attn_bwd_kernel`` (TPU kernel #4)."""
    q, k, v = _qkv((2, 3, 29, 64), seed=4)
    do = np.random.default_rng(5).standard_normal((2, 3, 29, 64)).astype(np.float32)
    _, refs = _jax_grads(lambda *a: flash_attention_bhld(*a, True), q, k, v, do)
    _, grads = _port_grads(tattn.flash_attention_bhld, q, k, v, do)
    _assert_grads_close(grads, refs)


def test_bloq_backward_matches_jax_qblocked_kernel():
    """The q-blocked entry against ``_attn_bwd_kernel_bloq`` (TPU kernel
    #5): two q blocks with padded rows, dk/dv summed over them."""
    b, h, l, d = 1, 8, 413, 16
    _, bq, nq = _qblock_plan(h, l, d)
    assert nq == 2 and nq * bq > l
    q, k, v = _qkv((b, h, l, d), seed=6)
    do = np.random.default_rng(7).standard_normal((b, l, h * d)).astype(np.float32)
    out_ref, refs = _jax_grads(lambda *a: _flash_bloq(*a, True), q, k, v, do)
    out, grads = _port_grads(tattn.flash_attention_bloq, q, k, v, do)
    np.testing.assert_allclose(out, out_ref, atol=ATOL, rtol=RTOL)
    _assert_grads_close(grads, refs)


@pytest.mark.parametrize("layout", tattn.LAYOUTS)
def test_backward_is_the_exact_gradient_in_float64(layout):
    """In float64 every rounding point of the TPU kernels' math is exact,
    so the plain backward is the gradient of the plain forward."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 5, 8))).requires_grad_()
               for _ in range(3))
    entry = tattn.flash_attention_blo if layout == "merged" else tattn.flash_attention_bhld
    assert torch.autograd.gradcheck(entry, (q, k, v))


def test_both_impls_differentiate_alike_on_cpu():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv((1, 2, 9, 16), seed=8))
    out_k = tattn.flash_attention_blo(q, k, v, impl="kernel")
    out_p = tattn.flash_attention_blo(q, k, v, impl="plain")
    assert torch.equal(out_k, out_p)
    grads_k = torch.autograd.grad(out_k.sum(), (q, k, v))
    grads_p = torch.autograd.grad(out_p.sum(), (q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(grads_k, grads_p))
    with pytest.raises(ValueError):
        tattn.flash_attention_blo(q, k, v, impl="pallas")
    o, lse = tattn.FlashAttention.apply(q, k, v, "merged", "kernel")
    assert o.requires_grad and not lse.requires_grad


@pytest.mark.parametrize("d", tattn.SUPPORTED_HEAD_DIMS)
def test_backward_route_by_head_dim(d):
    """Dh 64 and 80 take the wgmma backward, the other supported head dims
    the mma.sync one."""
    assert tattn.bwd_route(d) == ("wgmma" if d in tattn.SM90_HEAD_DIMS else "mma_sync")


@pytest.mark.parametrize("d", tattn.SUPPORTED_HEAD_DIMS)
def test_backward_route_under_deterministic_mode(d):
    """Under torch.use_deterministic_algorithms every head dim keeps its
    default routes, forward and backward: both backward kernels give the
    same bits on every call (neither adds across thread blocks)."""
    default = "wgmma" if d in tattn.SM90_HEAD_DIMS else "mma_sync"
    torch.use_deterministic_algorithms(True)
    try:
        assert tattn.bwd_route(d) == default
        assert tattn.fwd_route(d) == default
    finally:
        torch.use_deterministic_algorithms(False)
    assert tattn.bwd_route(d) == default


def test_backward_route_refuses_unsupported_head_dims():
    for d in (8, 72, 144):
        with pytest.raises(ValueError):
            tattn.bwd_route(d)
    with pytest.raises(ValueError):
        tattn.bwd_scratch_shape(1, 2, 64, 128)


@pytest.mark.parametrize("layout", tattn.LAYOUTS)
@pytest.mark.parametrize("d", [64, 80])
def test_tma_description_of_backward_operands(layout, d):
    """O and dO as the backward reads them: a merged (B, L, H·Dh) tensor is
    read as (B, H, L, Dh) with row stride H·Dh and head stride Dh."""
    b, h, l = 2, 3, 513
    shape = (b, h, l, d)
    x = torch.zeros((b, l, h * d) if layout == "merged" else shape, dtype=torch.bfloat16)
    view = tattn._heads_first(x, shape, layout)
    row, head, batch = ((h * d, d, l * h * d) if layout == "merged"
                        else (d, l * d, h * l * d))
    assert tattn.tma_description(view) == (
        (d, l, h, b, 2 * row, 2 * head, 2 * batch) + TMA_BOXES[d])
    assert view.data_ptr() == x.data_ptr()


@pytest.mark.parametrize("d", [64, 80])
def test_dq_accumulator_layout(d):
    """The wgmma backward keeps no dQ accumulator: its dQ kernel sums each
    q row's dq over the key tiles in registers, in order. Its one scratch
    is (lse, δ) padded to whole 64-row q tiles, the same at every Dh."""
    b, h, l = 2, 3, 589
    assert tattn.bwd_scratch_shape(b, h, l, d) == (2, b, h, 640)
    assert tattn.bwd_scratch_shape(b, h, l, d) == tattn.bwd_scratch_shape(b, h, l, 144 - d)


@pytest.mark.parametrize("l,tiles", [(1, 1), (64, 1), (65, 2), (197, 4), (1025, 17)])
def test_backward_scratch_covers_whole_q_tiles(l, tiles):
    assert tattn.bwd_scratch_shape(1, 2, l, 80) == (2, 1, 2, 64 * tiles)
