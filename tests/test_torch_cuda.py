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
Philox stream, the output bit for bit given the mask, with the seed by
value or from device memory. Under deterministic mode the backward repeats
bit for bit. CUDA graphs: a dropout graph takes the seed of each replay;
the attention forward and backward captured alone equal eager calls (O,
dk, dv bit for bit, dq within the run-to-run bound); the tiny model's
grouped train steps (``steps_per_call`` 4, a captured graph replayed once)
equal the one-step run bit for bit under deterministic mode, and with only
the backward on its atomic-free kernel; its grouped eval epoch the eager
one. The chip ops on the card equal the CPU's bit for bit; the granule
path launches the kernel once per block and chip batch and stitches the
fused predict's output bit for bit. A web task on the card equals the
CPU's (chips and manifest byte for byte, argmax on at least 0.99 of decided
pixels); a float32 model's task fails at stage 2 naming the dtype, with no
plain attention run in the kernel's place.
"""

import json
import os

import numpy as np
import pytest
import torch

from instageo_tpu_torch.ops import _build
from instageo_tpu_torch.ops import attention as tattn
from instageo_tpu_torch.ops import dropout as tdrop

BWD_REL_TOL = 1e-2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    # Deterministic cuBLAS for the deterministic-mode tests; read when
    # cuBLAS starts, so set before the first product.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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


def _dq_within_run_to_run(a, b):
    """The wgmma backward's dq from two runs: each element within one bf16
    step of the other, or, where its f32 partial sums cancel, within 2⁻¹⁶
    of its row's largest |dq| (a few f32 roundings of the partial sums,
    whose order changes)."""
    a, b = a.float(), b.float()
    step = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7  # one bf16 step, or less
    row = a.abs().amax(-1, keepdim=True) * 2.0 ** -16
    return bool(((a - b).abs() <= torch.maximum(step, row)).all())


@pytest.mark.parametrize("d", tattn.SM90_HEAD_DIMS)
def test_wgmma_backward_run_to_run(cuda, d):
    """dq within the run-to-run bound of itself; dk, dv equal."""
    q, k, v, o, do, lse = _bwd_inputs((4, 12, 589, d), "merged", cuda, seed=d)
    first = tattn.flash_attention_bwd(q, k, v, o, do, lse, "merged")
    for _ in range(3):
        again = tattn.flash_attention_bwd(q, k, v, o, do, lse, "merged")
        assert torch.equal(first[1], again[1]) and torch.equal(first[2], again[2])
        assert _dq_within_run_to_run(first[0], again[0])


def test_captured_attention_equals_eager(cuda):
    """The attention forward and backward captured alone at the crop
    model's training shape, on the wgmma backward: each replay's O, dk and
    dv equal an eager call's bit for bit, dq within the run-to-run bound."""
    shape = (8, 12, 589, 64)
    assert tattn.bwd_route(shape[-1]) == "wgmma"
    q, k, v = (t.requires_grad_() for t in _qkv(shape, cuda, seed=5))
    do = torch.randn((8, 589, 12 * 64), device=cuda).to(torch.bfloat16)

    def fwd_bwd():
        o = tattn.flash_attention_blo(q, k, v)
        return (o.detach(),) + torch.autograd.grad(o, (q, k, v), do)

    eager = fwd_bwd()
    graph = _build.CapturedGraph(fwd_bwd)
    assert graph.launches == {tattn.launches: 1, tattn.bwd_launches: 1}
    for _ in range(3):
        graph.replay()
        o, dq, dk, dv = graph.outputs
        assert torch.equal(o, eager[0])
        assert torch.equal(dk, eager[2]) and torch.equal(dv, eager[3])
        assert _dq_within_run_to_run(dq, eager[1])


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [7, 4099, 1 << 20])
def test_dropout_seed_from_device_memory(cuda, dtype, n):
    x = torch.randn(n, device=cuda).to(dtype)
    seeds = torch.tensor([5, 2**63 - 9, 1234], dtype=torch.int64, device=cuda)
    for slot in range(3):
        before = tdrop.launches.count
        out, mask = tdrop.fused_dropout_fwd(x, 0.2, (seeds, slot))
        assert tdrop.launches.count == before + 1
        by_value = tdrop.fused_dropout_fwd(x, 0.2, int(seeds[slot]))
        assert torch.equal(mask, by_value[1]) and torch.equal(out, by_value[0])
        _, plain = tdrop.fused_dropout_seeded_plain(x, 0.2, int(seeds[slot]))
        assert torch.equal(mask, plain)
    with pytest.raises(ValueError, match="by value"):
        tdrop._fused_dropout_cuda(x, 0.2, (seeds, 0), "x4")


def test_dropout_graph_takes_the_seed_of_each_replay(cuda):
    from instageo_tpu_torch.models.seg import SeedSlots

    x = torch.randn((8, 144, 56, 56), device=cuda).to(torch.bfloat16)
    slots = SeedSlots(1, cuda)
    graph = _build.CapturedGraph(lambda: tdrop.fused_dropout_fwd(x, 0.1, slots.take()))
    assert graph.launches == {tdrop.launches: 1}
    replays, masks = _build.graph_replays.count, []
    for seed in (3, 4):
        slots.buffer.fill_(seed)
        graph.replay()
        masks.append(graph.outputs[1].clone())
        assert torch.equal(masks[-1], tdrop.fused_dropout_seeded_plain(x, 0.1, seed)[1])
    assert not torch.equal(*masks)
    assert _build.graph_replays.count == replays + 2


@pytest.mark.parametrize("d", tattn.SM90_HEAD_DIMS)
def test_deterministic_backward_repeats_bit_for_bit(cuda, d):
    q, k, v = _qkv((2, 3, 197, d), cuda, seed=d)
    o, lse = tattn.flash_attention_fwd(q, k, v, "merged")
    do = torch.randn_like(o)
    torch.use_deterministic_algorithms(True)
    try:
        before = tattn.bwd_mma_launches.count
        first = tattn.flash_attention_bwd(q, k, v, o, do, lse, "merged")
        second = tattn.flash_attention_bwd(q, k, v, o, do, lse, "merged")
        assert tattn.bwd_mma_launches.count == before + 2
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _tiny_trainer(cuda, steps_per_call, model=None):
    from instageo_tpu_torch.models.seg import create_prithvi_seg
    from instageo_tpu_torch.train.trainer import Trainer

    if model is None:
        model = create_prithvi_seg("prithvi_eo_tiny", num_classes=3, depth=2, image_size=32,
                                   dtype=torch.bfloat16, param_dtype=torch.float32,
                                   device=cuda, seed=0)
    cfg = {"train": {"learning_rate": 1e-3, "weight_decay": 0.01, "ignore_index": -1,
                     "batch_size": 4, "scheduler": True},
           "model": {"num_classes": 3}, "tpu": {"steps_per_call": steps_per_call}}
    return Trainer(cfg, model, device=cuda, steps_per_epoch=8)


def _tiny_batches(n=8):
    rng = np.random.default_rng(9)
    return [(rng.normal(size=(4, 6, 1, 32, 32)).astype(np.float32),
             rng.integers(-1, 3, (4, 32, 32))) for _ in range(n)]


def test_captured_train_steps_equal_single_steps(cuda):
    """Deterministic mode: 8 batches at k = 4 (the first group as plain
    steps, then one replay of the captured group) against k = 1, with
    dropout and the schedule on: equal losses and parameters; the graph
    holds 4 steps' launches and replays them once."""
    from instageo_tpu_torch.train.trainer import epoch_generator

    runs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for k in (1, 4):
            trainer = _tiny_trainer(cuda, k)
            replays = _build.graph_replays.count
            losses = []
            trainer.run_train_epoch(iter(_tiny_batches()), epoch_generator(0, 0), 4, losses)
            runs.append(([float(v) for v in losses],
                         {n: p.detach().clone() for n, p in trainer.model.named_parameters()},
                         _build.graph_replays.count - replays, trainer))
    finally:
        torch.use_deterministic_algorithms(False)
    (losses_1, params_1, replays_1, _), (losses_4, params_4, replays_4, grouped) = runs
    assert replays_1 == 0 and replays_4 == 1
    assert losses_4 == losses_1
    for name, p in params_4.items():
        assert torch.equal(p, params_1[name]), name
    (group,) = grouped._groups.values()
    launches = {c: n for c, n in group.graph.launches.items()}
    assert launches[tdrop.launches] == 4 * 5 and launches[tattn.launches] == 4 * 2
    assert launches[tattn.bwd_mma_launches] == 4 * 2  # deterministic: the mma.sync backward


def test_captured_train_steps_equal_single_steps_on_the_atomic_free_backward(cuda):
    """Without deterministic mode, the backward alone moved to its kernel
    without atomics: k = 4 equals k = 1 bit for bit, so nothing in the
    captured step but the wgmma backward's dQ order differs from the eager
    step."""
    from unittest import mock

    from instageo_tpu_torch.train.trainer import epoch_generator

    runs = []
    with mock.patch.object(tattn, "bwd_route", lambda d: "mma_sync"):
        for k in (1, 4):
            trainer = _tiny_trainer(cuda, k)
            losses = []
            trainer.run_train_epoch(iter(_tiny_batches()), epoch_generator(0, 0), 4, losses)
            runs.append(([float(v) for v in losses],
                         {n: p.detach().clone() for n, p in trainer.model.named_parameters()}))
    (losses_1, params_1), (losses_4, params_4) = runs
    assert losses_4 == losses_1
    for name, p in params_4.items():
        assert torch.equal(p, params_1[name]), name


def test_captured_eval_equals_eager(cuda):
    eager = _tiny_trainer(cuda, 1)
    grouped = _tiny_trainer(cuda, 4, model=eager.model)
    for step in ("val", "test"):
        ref = eager.run_eval_epoch(iter(_tiny_batches()), 4, step)
        replays = _build.graph_replays.count
        got = grouped.run_eval_epoch(iter(_tiny_batches()), 4, step)
        assert _build.graph_replays.count == replays + 1
        assert set(got) == set(ref)
        for key, value in ref.items():
            assert got[key] == pytest.approx(value, rel=1e-6, abs=1e-6, nan_ok=True), key


def test_restore_on_card_keeps_a_capturable_optimizer(cuda, tmp_path):
    """A checkpoint of a card run restores into a capturable AdamW (the
    rate a device tensor, the step counts on the card) whose grouped steps
    go on: a resumed epoch equals an unbroken second epoch under
    deterministic mode."""
    from instageo_tpu_torch.train.checkpointing import BestCheckpointer
    from instageo_tpu_torch.train.trainer import epoch_generator

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        straight = _tiny_trainer(cuda, 4)
        for epoch in range(2):
            straight.run_train_epoch(iter(_tiny_batches()), epoch_generator(0, epoch), 4)
        first = _tiny_trainer(cuda, 4)
        first.run_train_epoch(iter(_tiny_batches()), epoch_generator(0, 0), 4)
        ckpt = BestCheckpointer(str(tmp_path))
        ckpt.save(first.state_dict())
        resumed = _tiny_trainer(cuda, 4)
        resumed.restore(ckpt.path)
        group = resumed.optimizer.param_groups[0]
        assert group["capturable"] and group["lr"].device.type == "cuda"
        state = next(iter(resumed.optimizer.state.values()))
        assert state["step"].device.type == "cuda"
        resumed.run_train_epoch(iter(_tiny_batches()), epoch_generator(0, 1), 4)
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed.step == straight.step == 16
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("layout", tattn.LAYOUTS)
@pytest.mark.parametrize("d", [64, 80, 32])
def test_custom_op_is_the_kernel_call(cuda, layout, d):
    """``instageo_tpu_torch::flash_attn_fwd`` on CUDA tensors launches the
    route's kernel once and gives its O and lse bit for bit."""
    q, k, v = _qkv((2, 4, 197, d), cuda, seed=d)
    ref_o, ref_lse = tattn.flash_attention_fwd(q, k, v, layout)
    before = tattn.launches.count
    o, lse = torch.ops.instageo_tpu_torch.flash_attn_fwd(q, k, v, layout)
    assert tattn.launches.count == before + 1
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)


def test_exported_artifact_launches_the_kernel(cuda, tmp_path):
    """The tiny model exported on the card: the artifact's predict launches
    the forward kernel once per block and gives the live predict's class ids
    (the same kernel on the same inputs)."""
    from instageo_tpu_torch.models.seg import create_prithvi_seg
    from instageo_tpu_torch.serve.export import export_predict, load_predict
    from instageo_tpu_torch.serve.infer import make_predict_fn

    model = create_prithvi_seg("prithvi_eo_tiny", depth=2, image_size=32, num_classes=3,
                               dtype=torch.bfloat16, device=cuda)
    path = export_predict(model, str(tmp_path / "p.pt2"), num_bands=6, img_size=32)
    predict, meta = load_predict(path)
    assert meta["device"] == "cuda"
    x = torch.randn(5, 6, 1, 32, 32, generator=torch.Generator().manual_seed(1))
    before = tattn.launches.count
    got = predict(model.state_dict(), x)
    torch.cuda.synchronize()
    assert tattn.launches.count == before + 2
    assert got.device.type == "cuda" and got.shape == (5, 32, 32)
    assert torch.equal(got, make_predict_fn(model)(x))


@pytest.mark.parametrize("strategy", ["each", "any"])
def test_process_tile_chips_on_card_equals_cpu(cuda, strategy):
    """The chip ops on the card give the CPU's chips, seg maps and validity
    bit for bit and dtype for dtype (uint16 tile, Fmask masking, windows,
    one dense chip in a bucket of its own)."""
    from instageo_tpu_torch.ops.chip_ops import process_tile_chips

    rng = np.random.default_rng(0)
    tile = rng.integers(0, 40000, (6, 64, 64)).astype(np.uint16)
    tile[:, :5, :5] = 0
    fmask = rng.choice(np.asarray([0, 2, 8, 10, 32], np.uint8), (2, 64, 64))
    coords = np.asarray([[x, y] for y in range(4) for x in range(4)], np.int32)
    rc = np.concatenate([rng.integers(0, 64, (300, 2)), rng.integers(16, 32, (700, 2))])
    owner = (rc[:, 0] // 16) * 4 + rc[:, 1] // 16
    labels = rng.integers(0, 9, len(rc)).astype(np.float32)
    kw = dict(chip_size=16, no_data_value=0, mask_types=("cloud", "cloud_shadow"),
              masking_strategy=strategy, window_size=1, max_points_per_chip=64)
    args = (tile, fmask, coords, rc, labels, owner)
    for got, ref in zip(process_tile_chips(*args, device=cuda, **kw),
                        process_tile_chips(*args, device="cpu", **kw)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_granule_on_card_runs_the_kernel_and_stitches(cuda):
    """``granule_inference`` on the card: one forward launch per block and
    chip batch, and the canvas is the fused predict on each batch of chips
    (the last padded to the batch size), pasted in chip order, bit for bit;
    −1 on the nodata corner."""
    from instageo_tpu_torch.models.seg import create_prithvi_seg
    from instageo_tpu_torch.ops.preprocess import make_fused_predict_fn
    from instageo_tpu_torch.serve import granule

    model = create_prithvi_seg("prithvi_eo_tiny", num_classes=3, image_size=32, num_bands=6,
                               depth=2, dtype=torch.bfloat16, device=cuda, seed=0).eval()
    tile = np.random.default_rng(1).integers(1, 10000, (6, 80, 100)).astype(np.uint16)
    tile[:, :10, :10] = 0
    mean, std = [5000.0] * 6, [3000.0] * 6
    tattn.launches.reset()
    pred, _ = granule.granule_inference(tile, model, mean, std, chip_size=32, batch_size=5)
    coords, _ = granule.chip_grid(80, 100, 32)
    assert tattn.launches.total() == 2 * -(-len(coords) // 5)
    predict = make_fused_predict_fn(model, mean, std)
    expected = np.zeros((80, 100), np.int8)
    for b0 in range(0, len(coords), 5):  # the last batch padded as the granule path pads it
        ids = list(coords[b0:b0 + 5]) + [(0, 0)] * max(0, b0 + 5 - len(coords))
        raw = np.stack([tile[:, y:y + 32, x:x + 32] for x, y in ids])
        out = predict(raw).cpu().numpy()
        out[(raw == 0).all(axis=1)] = -1
        for j, (x, y) in enumerate(coords[b0:b0 + 5]):
            expected[y:y + 32, x:x + 32] = out[j]
    np.testing.assert_array_equal(pred, expected)
    assert (pred[:10, :10] == -1).all()


def _small_hls_world(root):
    """One HLS granule of a 64 px tile (six uint16 bands and an Fmask with
    cloud, shadow and water bits), its STAC item dict, and an observations
    CSV of 40 seeded points in EPSG:4326."""
    import pandas as pd

    from instageo_tpu_torch.data.crs import latlon_to_utm, utm_to_latlon
    from instageo_tpu_torch.data.geotiff import Affine, write_geotiff

    e0, n0, zone, south = latlon_to_utm(43.0, 15.0)
    ox, oy = float(e0) - 960.0, float(n0) + 960.0
    tr = Affine.from_origin(ox, oy, 30.0, 30.0)
    rng = np.random.default_rng(2)
    assets = {}
    for b in ("B02", "B03", "B04", "B8A", "B11", "B12", "Fmask"):
        arr = (rng.choice(np.asarray([0, 0, 2, 8, 32], np.uint16), (64, 64)) if b == "Fmask"
               else rng.integers(100, 5000, (64, 64)).astype(np.uint16))
        assets[b] = {"href": os.path.join(root, f"{b}.tif")}
        write_geotiff(assets[b]["href"], arr[None], transform=tr, crs=32633, nodata=0)
    lat_a, lon_a = utm_to_latlon(ox, oy - 1920.0, zone, south)
    lat_b, lon_b = utm_to_latlon(ox + 1920.0, oy, zone, south)
    item = {"id": "HLS.S30.T33TUN.2022145T100000.v2.0", "collection": "HLSS30_2.0",
            "bbox": [float(lon_a), float(lat_a), float(lon_b), float(lat_b)],
            "properties": {"datetime": "2022-05-25T10:00:00Z", "eo:cloud_cover": 5},
            "assets": assets}
    px = rng.uniform(0, 64, (40, 2))
    lat, lon = utm_to_latlon(ox + px[:, 0] * 30.0, oy - px[:, 1] * 30.0, zone, south)
    path = os.path.join(root, "obs.csv")
    pd.DataFrame({"x": lon, "y": lat, "label": rng.integers(0, 2, 40),
                  "date": "2022-05-25"}).to_csv(path, index=False)
    return item, path


def test_chip_creator_on_card_equals_cpu(cuda, tmp_path, monkeypatch):
    """The point chip creator (HLS, cloud and shadow masking, a 3x3 window)
    with ``--device=cuda`` writes the same files as with ``--device=cpu``,
    byte for byte."""
    from instageo_tpu_torch.data import chip_creator, stac
    from instageo_tpu_torch.data.sources import hls

    item, obs = _small_hls_world(str(tmp_path))
    monkeypatch.setattr(stac.StacClient, "search",
                        lambda self, **kw: [stac.StacItem.from_dict(json.loads(json.dumps(item)))])
    monkeypatch.setattr(hls, "retrieve_stac_metadata", hls.retrieve_stac_metadata.__wrapped__)
    monkeypatch.setattr(stac, "_load_asset", stac._load_asset.__wrapped__)
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = tmp_path / dev
        chip_creator.main([f"--dataframe_path={obs}", f"--output_directory={outs[dev]}",
                           "--data_source=HLS", "--chip_size=32", "--min_count=1",
                           "--noshift_to_month_start", "--is_time_series_task=false",
                           "--mask_types=cloud,cloud_shadow", "--window_size=1",
                           f"--device={dev}"])
    files = sorted(str(p.relative_to(outs["cpu"])) for p in outs["cpu"].rglob("*") if p.is_file())
    assert len([f for f in files if f.startswith("chips/")]) == 4
    assert files == sorted(str(p.relative_to(outs["cuda"])) for p in outs["cuda"].rglob("*")
                           if p.is_file())
    for f in files:
        assert (outs["cuda"] / f).read_bytes() == (outs["cpu"] / f).read_bytes(), f


def test_web_task_on_card_equals_cpu(cuda, tmp_path, monkeypatch):
    """A web task (the tiny model in bf16, as the port serves on the card; one
    96 px HLS granule, 32 px chips) through the three stages drained in process
    with ``INSTAGEO_DEVICE=cuda`` and with ``cpu``: the chips and the manifest
    byte for byte; the predictions' argmax agrees on at least 0.99 of decided
    pixels (the CPU logits' top-2 gap at least 0.01 x their max |logit|, as
    ``chip_smoke.py`` decides serving pixels)."""
    from instageo_tpu_torch.configs.config import load_config, merge
    from instageo_tpu_torch.data import stac
    from instageo_tpu_torch.data.geotiff import GeoTiffReader
    from instageo_tpu_torch.data.sources import hls
    from instageo_tpu_torch.ops.preprocess import preprocess_chips, raw_to_device
    from instageo_tpu_torch.serve.server import ModelServer
    from instageo_tpu_torch.train.checkpointing import BestCheckpointer
    from instageo_tpu_torch.train.factory import create_model
    from instageo_tpu_torch.webapp import queue, settings
    from instageo_tpu_torch.webapp.tasks import Task
    import torch_webapp_helpers as helpers  # tests/ is on sys.path (no __init__.py)

    item, bbox = helpers.granule_world(str(tmp_path))
    cfg = load_config("config", overrides={**helpers.model_overrides(),
                                           "tpu.precision": "bf16"})
    ckpt = BestCheckpointer(str(tmp_path / "run")).save(
        {"model": create_model(cfg, seed=0, device="cpu").state_dict()})
    registry, models = helpers.write_model(str(tmp_path), cfg.to_yaml(), ckpt)
    monkeypatch.setenv("MODELS_REGISTRY_PATH", registry)
    monkeypatch.setenv("MODELS_PATH", models)
    monkeypatch.setattr(stac.StacClient, "search",
                        lambda self, **kw: [stac.StacItem.from_dict(helpers.copy_item(item))])
    monkeypatch.setattr(hls, "retrieve_stac_metadata", hls.retrieve_stac_metadata.__wrapped__)
    monkeypatch.setattr(stac, "_load_asset", stac._load_asset.__wrapped__)
    monkeypatch.setattr(settings.settings, "TASKS_DATA_DIR", str(tmp_path / "tasks"))
    dbp = str(tmp_path / "web.sqlite")
    dirs = {}
    for dev in ("cuda", "cpu"):
        monkeypatch.setattr(settings.settings, "DEVICE", dev)
        task = Task(bboxes=[bbox], parameters={"date": "2024-06-01", "chip_size": 32,
                                               "num_steps": 1, "data_source": "HLS"},
                    model_key="toy_model", model_size="base", db_path=dbp)
        task.save()
        task.start_data_processing()
        assert queue.drain(db_path=dbp) == 3
        assert Task.load(task.task_id, dbp).status == "completed", Task.load(task.task_id, dbp).stages
        dirs[dev] = task.data_dir
    chips = sorted(os.listdir(os.path.join(dirs["cpu"], "chips")))
    assert chips and chips == sorted(os.listdir(os.path.join(dirs["cuda"], "chips")))
    for rel in [os.path.join("chips", c) for c in chips] + ["hls_raster_dataset.csv"]:
        with open(os.path.join(dirs["cuda"], rel), "rb") as a, \
                open(os.path.join(dirs["cpu"], rel), "rb") as b:
            assert a.read() == b.read(), rel
    model = ModelServer(merge(cfg, {"checkpoint_path": ckpt, "device": "cpu"})).model
    same = decided = 0
    for c in chips:
        with GeoTiffReader(os.path.join(dirs["cpu"], "chips", c)) as r:
            raw = r.read()[None]
        x = preprocess_chips(raw_to_device(raw, torch.device("cpu")), torch.tensor(helpers.MEAN),
                             torch.tensor(helpers.STD), 1, torch.arange(6), 1.0, img_size=32)
        with torch.no_grad():
            logits = model(x, channels_last=True)[0].float()
        top2 = logits.topk(2, dim=-1).values
        ok = ((top2[..., 0] - top2[..., 1]) >= 0.01 * logits.abs().max()).numpy()
        preds = []
        for dev in ("cuda", "cpu"):
            with GeoTiffReader(os.path.join(dirs[dev], "predictions",
                                            c.replace("chip", "prediction"))) as r:
                preds.append(r.read(1))
        same += int((preds[0] == preds[1])[ok].sum())
        decided += int(ok.sum())
    assert decided > 0 and same >= 0.99 * decided


def test_web_task_f32_model_fails_on_card_naming_dtype(cuda, tmp_path, monkeypatch):
    """An f32 model config on ``INSTAGEO_DEVICE=cuda`` is not served (the
    Hopper attention kernels take bf16 only): stage 2 fails the task with the
    wrapper's message naming the dtype, writes no predictions, launches no
    kernel and never runs the plain attention or SDPA in its place."""
    import torch.nn.functional as F

    from instageo_tpu_torch.configs.config import load_config
    from instageo_tpu_torch.data import stac
    from instageo_tpu_torch.data.sources import hls
    from instageo_tpu_torch.train.checkpointing import BestCheckpointer
    from instageo_tpu_torch.train.factory import create_model
    from instageo_tpu_torch.webapp import queue, settings
    from instageo_tpu_torch.webapp.tasks import Task
    import torch_webapp_helpers as helpers  # tests/ is on sys.path (no __init__.py)

    item, bbox = helpers.granule_world(str(tmp_path))
    cfg = load_config("config", overrides=helpers.model_overrides())
    assert cfg.tpu.precision == "f32"
    ckpt = BestCheckpointer(str(tmp_path / "run")).save(
        {"model": create_model(cfg, seed=0, device="cpu").state_dict()})
    registry, models = helpers.write_model(str(tmp_path), cfg.to_yaml(), ckpt)
    monkeypatch.setenv("MODELS_REGISTRY_PATH", registry)
    monkeypatch.setenv("MODELS_PATH", models)
    monkeypatch.setattr(stac.StacClient, "search",
                        lambda self, **kw: [stac.StacItem.from_dict(helpers.copy_item(item))])
    monkeypatch.setattr(hls, "retrieve_stac_metadata", hls.retrieve_stac_metadata.__wrapped__)
    monkeypatch.setattr(stac, "_load_asset", stac._load_asset.__wrapped__)
    monkeypatch.setattr(settings.settings, "TASKS_DATA_DIR", str(tmp_path / "tasks"))
    monkeypatch.setattr(settings.settings, "DEVICE", "cuda")
    plain_calls = []

    def recording(fn):
        def wrapper(*args, **kwargs):
            plain_calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(tattn, "flash_attention_fwd_plain",
                        recording(tattn.flash_attention_fwd_plain))
    monkeypatch.setattr(F, "scaled_dot_product_attention",
                        recording(F.scaled_dot_product_attention))
    dbp = str(tmp_path / "web.sqlite")
    task = Task(bboxes=[bbox], parameters={"date": "2024-06-01", "chip_size": 32,
                                           "num_steps": 1, "data_source": "HLS"},
                model_key="toy_model", model_size="base", db_path=dbp)
    task.save()
    task.start_data_processing()
    launches0 = tattn.launches.count
    assert queue.drain(db_path=dbp) == 2
    rec = Task.load(task.task_id, dbp)
    assert rec.status == "failed", rec.stages
    assert rec.stages["data_processing"]["status"] == "completed", rec.stages
    assert rec.stages["model_prediction"]["status"] == "failed", rec.stages
    assert ("the attention kernels take bfloat16; q is torch.float32"
            in rec.stages["model_prediction"]["error"]), rec.stages
    pred_dir = os.path.join(rec.data_dir, "predictions")
    assert not os.path.isdir(pred_dir) or os.listdir(pred_dir) == []
    assert tattn.launches.count == launches0
    assert plain_calls == []
