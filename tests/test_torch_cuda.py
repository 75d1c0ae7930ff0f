"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where CUDA is not available. This file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: bf16 outputs atol = rtol = 3e-2 (as the JAX package's bf16
attention test), lse atol 1e-3 (float32 statistics, other summation order).
"""

import pytest
import torch

from instageo_tpu_torch.ops import attention as tattn

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


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 33, 64), cuda)
    with pytest.raises(TypeError):
        tattn.flash_attention_fwd(q.float(), k.float(), v.float())
    q, k, v = _qkv((1, 2, 33, 72), cuda)
    with pytest.raises(ValueError):
        tattn.flash_attention_fwd(q, k, v)
