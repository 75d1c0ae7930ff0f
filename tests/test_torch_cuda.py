"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where CUDA is not available. This file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: bf16 outputs atol = rtol = 3e-2 (as the JAX package's bf16
attention test), lse atol 1e-3 (float32 statistics, other summation order).
Backward: dq, dk, dv within ‖Δ‖/‖ref‖ ≤ 1e-2 of the plain version (both
round dS and P to bf16, but at other summation orders, so single elements
can differ by a bf16 rounding); the wgmma backward's dq from one run to
the next within one bf16 step (its f32 reduce-adds arrive in any order),
dk and dv bit for bit. Dropout: the mask bit for bit equal to the plain
Philox stream, the output bit for bit given the mask.
"""

import pytest
import torch

from instageo_tpu_torch.ops import attention as tattn
from instageo_tpu_torch.ops import dropout as tdrop

BWD_REL_TOL = 1e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
            for _ in range(3)]


@pytest.mark.parametrize("layout", tattn.LAYOUTS)
@pytest.mark.parametrize("b,h,l,d", [(2, 3, 77, 64), (1, 2, 130, 80), (2, 2, 64, 128)])
def test_kernel_matches_plain(cuda, layout, b, h, l, d):
    q, k, v = _qkv((b, h, l, d), cuda)
    before = tattn.launches.count
    o, lse = tattn.flash_attention_fwd(q, k, v, layout)
    torch.cuda.synchronize()
    assert tattn.launches.count == before + 1
    o_ref, lse_ref = tattn.flash_attention_fwd_plain(q, k, v, layout)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


def test_kernel_reads_strided_qkv_views(cuda):
    b, l, h, d = 2, 99, 4, 64
    qkv = torch.randn((b, l, 3, h, d), device=cuda).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o = tattn.flash_attention_blo(q, k, v)
    o_copy = tattn.flash_attention_blo(*(t.contiguous() for t in (q, k, v)))
    torch.testing.assert_close(o, o_copy, atol=0, rtol=0)


@pytest.mark.parametrize("layout", tattn.LAYOUTS)
@pytest.mark.parametrize("l", [1, 77, 127, 128, 129, 197, 589])
@pytest.mark.parametrize("d", tattn.SM90_HEAD_DIMS)
def test_wgmma_route_matches_plain(cuda, layout, l, d):
    """Lengths on both sides of the 128-row tiles, L = 1 included (O = v,
    lse = scale·q·k)."""
    q, k, v = _qkv((2, 3, l, d), cuda, seed=l)
    o, lse = tattn.flash_attention_fwd(q, k, v, layout)
    torch.cuda.synchronize()
    o_ref, lse_ref = tattn.flash_attention_fwd_plain(q, k, v, layout)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("d", tattn.SM90_HEAD_DIMS)
def test_wgmma_route_on_large_scores(cuda, d):
    """Inputs ×8 give scores of order 64·√Dh: the exp2 fold of the scale
    and the running max still match the plain version."""
    q, k, v = (8 * x for x in _qkv((2, 2, 197, d), cuda, seed=3))
    o, lse = tattn.flash_attention_fwd(q, k, v, "merged")
    o_ref, lse_ref = tattn.flash_attention_fwd_plain(q, k, v, "merged")
    torch.testing.assert_close(o.float(), o_ref.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("layout", tattn.LAYOUTS)
@pytest.mark.parametrize("d", tattn.SM90_HEAD_DIMS)
def test_wgmma_route_reads_qkv_views(cuda, layout, d):
    """q/k/v as the model passes them, views of one (B, L, 3, H, Dh)
    buffer, give the same bits as contiguous copies."""
    b, l, h = 2, 197, 3
    qkv = torch.randn((b, l, 3, h, d), device=cuda).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o, lse = tattn.flash_attention_fwd(q, k, v, layout)
    o_copy, lse_copy = tattn.flash_attention_fwd(*(t.contiguous() for t in (q, k, v)), layout)
    assert torch.equal(o, o_copy) and torch.equal(lse, lse_copy)


@pytest.mark.parametrize("d,route", [(64, "wgmma"), (80, "wgmma"), (128, "mma_sync")])
def test_forward_route_counters(cuda, d, route):
    assert tattn.fwd_route(d) == route
    q, k, v = _qkv((1, 2, 33, d), cuda)
    fwd0, mma0 = tattn.launches.count, tattn.fwd_mma_launches.count
    tattn.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert tattn.launches.count - fwd0 == 1
    assert tattn.fwd_mma_launches.count - mma0 == (route == "mma_sync")


@pytest.mark.parametrize("d", tattn.SM90_HEAD_DIMS)
def test_mma_sync_route_still_matches_plain_at_wgmma_head_dims(cuda, d):
    """The mma.sync design, timed beside the wgmma one at Dh 64 and 80."""
    q, k, v = _qkv((2, 3, 197, d), cuda)
    o, lse = tattn._flash_attention_fwd_cuda(q, k, v, "merged", "mma_sync")
    o_ref, lse_ref = tattn.flash_attention_fwd_plain(q, k, v, "merged")
    torch.testing.assert_close(o.float(), o_ref.float(), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("d", tattn.SM90_HEAD_DIMS)
def test_autograd_through_wgmma_forward(cuda, d):
    """The wgmma forward's O and lse feed the unchanged backward kernel."""
    b, l, h = 2, 197, 3
    qkv = torch.randn((b, l, 3, h, d), device=cuda).to(torch.bfloat16).requires_grad_()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    mma0 = tattn.fwd_mma_launches.count
    out = tattn.flash_attention_blo(q, k, v)
    do = torch.randn(out.shape, device=cuda).to(torch.bfloat16)
    out.backward(do)
    torch.cuda.synchronize()
    assert tattn.fwd_mma_launches.count == mma0
    leaf = qkv.detach().requires_grad_()
    out_p = tattn.flash_attention_blo(*(leaf[:, :, i].transpose(1, 2) for i in range(3)),
                                      impl="plain")
    out_p.backward(do)
    torch.testing.assert_close(out.float(), out_p.float(), atol=3e-2, rtol=3e-2)
    assert _rel_err(qkv.grad, leaf.grad) <= BWD_REL_TOL


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 33, 64), cuda)
    with pytest.raises(TypeError):
        tattn.flash_attention_fwd(q.float(), k.float(), v.float())
    q, k, v = _qkv((1, 2, 33, 72), cuda)
    with pytest.raises(ValueError):
        tattn.flash_attention_fwd(q, k, v)


def _rel_err(x, ref):
    return ((x.float() - ref.float()).norm() / ref.float().norm()).item()


def _bwd_inputs(shape, layout, device, seed=1):
    q, k, v = _qkv(shape, device, seed)
    o, lse = tattn.flash_attention_fwd(q, k, v, layout)
    g = torch.Generator(device=device).manual_seed(seed + 100)
    do = torch.randn(o.shape, generator=g, device=device).to(torch.bfloat16)
    return q, k, v, o, do, lse


@pytest.mark.parametrize("layout", tattn.LAYOUTS)
@pytest.mark.parametrize("b,h,l,d", [(2, 3, 77, 64), (1, 2, 130, 80), (2, 2, 64, 128),
                                     (1, 1, 5, 16)])
def test_bwd_kernel_matches_plain(cuda, layout, b, h, l, d):
    q, k, v, o, do, lse = _bwd_inputs((b, h, l, d), layout, cuda)
    before = tattn.bwd_launches.count
    grads = tattn.flash_attention_bwd(q, k, v, o, do, lse, layout)
    torch.cuda.synchronize()
    assert tattn.bwd_launches.count == before + 1
    refs = tattn.flash_attention_bwd_plain(q, k, v, o, do, lse, layout)
    for name, g, ref in zip("qkv", grads, refs):
        assert g.shape == (b, h, l, d) and g.dtype == torch.bfloat16
        assert torch.isfinite(g).all()
        assert _rel_err(g, ref) <= BWD_REL_TOL, f"d{name}: {_rel_err(g, ref)}"


@pytest.mark.parametrize("d", tattn.SM90_HEAD_DIMS)
@pytest.mark.parametrize("entry", [tattn.flash_attention_blo, tattn.flash_attention_bhld,
                                   tattn.flash_attention_bloq])
def test_autograd_through_both_kernels(cuda, entry, d):
    b, l, h = 2, 99, 4
    qkv = torch.randn((b, l, 3, h, d), device=cuda).to(torch.bfloat16).requires_grad_()
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    fwd0, bwd0 = tattn.launches.count, tattn.bwd_launches.count
    mma0 = tattn.bwd_mma_launches.count
    out = entry(q, k, v)
    do = torch.randn(out.shape, device=cuda).to(torch.bfloat16)
    out.backward(do)
    torch.cuda.synchronize()
    assert (tattn.launches.count - fwd0, tattn.bwd_launches.count - bwd0) == (1, 1)
    assert tattn.bwd_mma_launches.count == mma0
    leaf = qkv.detach().requires_grad_()
    qp, kp, vp = (leaf[:, :, i].transpose(1, 2) for i in range(3))
    entry(qp, kp, vp, impl="plain").backward(do)
    assert _rel_err(qkv.grad, leaf.grad) <= BWD_REL_TOL


def test_bwd_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, o, do, lse = _bwd_inputs((1, 2, 33, 64), "merged", cuda)
    with pytest.raises(TypeError):
        tattn.flash_attention_bwd(q.float(), k.float(), v.float(), o.float(),
                                  do.float(), lse, "merged")
    x = torch.zeros((1, 2, 33, 72), device=cuda, dtype=torch.bfloat16)
    o72 = torch.zeros((1, 33, 144), device=cuda, dtype=torch.bfloat16)
    lse72 = torch.zeros((1, 2, 33, 1), device=cuda)
    with pytest.raises(ValueError):
        tattn.flash_attention_bwd(x, x, x, o72, o72, lse72, "merged")


@pytest.mark.parametrize("layout", tattn.LAYOUTS)
@pytest.mark.parametrize("l", [1, 63, 64, 65, 127, 128, 129, 197, 589])
@pytest.mark.parametrize("d", tattn.SM90_HEAD_DIMS)
def test_wgmma_backward_matches_plain(cuda, layout, l, d):
    """Lengths on both sides of the 64-row q tiles and the 128-key tiles."""
    q, k, v, o, do, lse = _bwd_inputs((2, 3, l, d), layout, cuda, seed=l)
    mma0 = tattn.bwd_mma_launches.count
    grads = tattn.flash_attention_bwd(q, k, v, o, do, lse, layout)
    torch.cuda.synchronize()
    assert tattn.bwd_mma_launches.count == mma0
    refs = tattn.flash_attention_bwd_plain(q, k, v, o, do, lse, layout)
    for name, g, ref in zip("qkv", grads, refs):
        assert torch.isfinite(g).all()
        if l == 1 and name != "v":
            # One key: P = 1 and dS = dP − δ = 0 up to the summation order,
            # so dq and dk are rounding noise on both sides.
            assert g.abs().max().item() <= 1e-3 and ref.abs().max().item() <= 1e-3
            continue
        assert _rel_err(g, ref) <= BWD_REL_TOL, f"d{name}: {_rel_err(g, ref)}"


@pytest.mark.parametrize("d", tattn.SM90_HEAD_DIMS)
def test_wgmma_backward_run_to_run(cuda, d):
    """dq within one bf16 step of itself from run to run, or, where its f32
    partial sums cancel, within 2⁻¹⁶ of its row's largest |dq| (a few f32
    roundings of the partial sums, whose order changes); dk, dv equal."""
    q, k, v, o, do, lse = _bwd_inputs((4, 12, 589, d), "merged", cuda, seed=d)
    first = tattn.flash_attention_bwd(q, k, v, o, do, lse, "merged")
    for _ in range(3):
        again = tattn.flash_attention_bwd(q, k, v, o, do, lse, "merged")
        assert torch.equal(first[1], again[1]) and torch.equal(first[2], again[2])
        a, b = first[0].float(), again[0].float()
        step = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7  # one bf16 step, or less
        row = a.abs().amax(-1, keepdim=True) * 2.0 ** -16
        assert bool(((a - b).abs() <= torch.maximum(step, row)).all())


@pytest.mark.parametrize("d,route", [(64, "wgmma"), (80, "wgmma"), (128, "mma_sync")])
def test_backward_route_counters(cuda, d, route):
    assert tattn.bwd_route(d) == route
    q, k, v, o, do, lse = _bwd_inputs((1, 2, 33, d), "merged", cuda)
    bwd0, mma0 = tattn.bwd_launches.count, tattn.bwd_mma_launches.count
    tattn.flash_attention_bwd(q, k, v, o, do, lse, "merged")
    torch.cuda.synchronize()
    assert tattn.bwd_launches.count - bwd0 == 1
    assert tattn.bwd_mma_launches.count - mma0 == (route == "mma_sync")


@pytest.mark.parametrize("d", tattn.SM90_HEAD_DIMS)
def test_mma_sync_backward_still_matches_plain_at_wgmma_head_dims(cuda, d):
    """The mma.sync design, timed beside the wgmma one at Dh 64 and 80."""
    q, k, v, o, do, lse = _bwd_inputs((2, 3, 197, d), "merged", cuda)
    grads = tattn._flash_attention_bwd_cuda(q, k, v, o, do, lse, "merged", "mma_sync")
    refs = tattn.flash_attention_bwd_plain(q, k, v, o, do, lse, "merged")
    for g, ref in zip(grads, refs):
        assert _rel_err(g, ref) <= BWD_REL_TOL


@pytest.mark.parametrize("design", tdrop.DESIGNS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 4099, 1 << 20])
def test_dropout_mask_is_the_plain_stream(cuda, design, dtype, n):
    """Bit for bit the plain Philox stream, with ragged tails and, one
    element in, unaligned starts (the scalar path)."""
    x = torch.randn(n + 1, device=cuda).to(dtype)
    for view in (x[:n], x[1:]):
        out, mask = tdrop._fused_dropout_cuda(view, 0.3, 12345678901, design)
        _, ref = tdrop.fused_dropout_seeded_plain(view, 0.3, 12345678901)
        assert torch.equal(mask, ref)
        assert torch.equal(out, tdrop.dropout_apply(view, mask, 0.3))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 16, 64, 64), (1,)])
def test_dropout_kernel_is_exact_given_its_mask(cuda, dtype, shape):
    x = torch.randn(shape, device=cuda).to(dtype)
    before = tdrop.launches.count
    out, mask = tdrop.fused_dropout_fwd(x, 0.3, seed=7)
    torch.cuda.synchronize()
    assert tdrop.launches.count == before + 1
    assert out.dtype == dtype and mask.dtype == torch.bool and mask.shape == x.shape
    assert torch.equal(out, tdrop.dropout_apply(x, mask, 0.3))
    again, mask2 = tdrop.fused_dropout_fwd(x, 0.3, seed=7)
    assert torch.equal(mask, mask2) and torch.equal(out, again)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_kernel_keep_rate_and_streams(cuda, p):
    n = 1 << 22
    x = torch.ones(n, device=cuda, dtype=torch.bfloat16)
    _, mask = tdrop.fused_dropout_fwd(x, p, seed=1)
    keep = mask.float().mean().item()
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(keep - (1 - p)) <= 5 * sigma
    _, other = tdrop.fused_dropout_fwd(x, p, seed=2)
    assert not torch.equal(mask, other)
    # A view one element in is not aligned for 4-element vectors: the scalar
    # path gives the same mask as the vector path on an aligned copy.
    _, tail = tdrop.fused_dropout_fwd(x[1:], p, seed=1)
    _, aligned = tdrop.fused_dropout_fwd(x[1:].clone(), p, seed=1)
    assert torch.equal(tail, aligned)


def test_dropout_kernel_backward_and_edges(cuda):
    x = torch.randn((4, 33, 17), device=cuda, dtype=torch.bfloat16, requires_grad=True)
    out = tdrop.fused_dropout(x, 0.2, seed=3)
    g = torch.randn_like(out)
    out.backward(g)
    _, mask = tdrop.fused_dropout_fwd(x.detach(), 0.2, seed=3)
    assert torch.equal(x.grad, tdrop.dropout_apply(g, mask, 0.2))
    same, keep_all = tdrop.fused_dropout_fwd(x.detach(), 0.0, seed=3)
    assert keep_all.all() and torch.equal(same, x.detach())
    with pytest.raises(ValueError):
        tdrop.fused_dropout_fwd(x.detach(), 1.0, seed=3)
    with pytest.raises(TypeError):
        tdrop.fused_dropout_fwd(x.detach().half(), 0.2, seed=3)
