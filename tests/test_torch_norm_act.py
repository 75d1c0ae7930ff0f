"""The encoder's LayerNorm (``ops/norm_act.py``) and exact GELU on the CPU.

A bf16 tensor on the CPU, and a float32 one anywhere, takes the plain
versions, which are the float32 round trip the blocks ran before the kernels
(``F.layer_norm(x.float(), ...).to(x.dtype)``, ``F.gelu(y.float()).to(y.dtype)``):
``Block`` and ``Mlp`` give that round trip's outputs and gradients bit for
bit. The custom ops run the plain versions on CPU tensors, through their
autograd registration, bit for bit; their fake versions give the kernels'
shapes and dtypes for fake CUDA tensors, and a bf16 CUDA tensor dispatches
to them while a float32 one stays on the plain path. On a (fake) CUDA
tensor ``Mlp``'s exact GELU is one GELU in the compute dtype, with no
float32 cast. The kernels' symbols fall in the benchmark's elementwise
class, and the training CLI's launch counts name them. The table of the
port's kernels (``ops.kernels()``) covers every ``csrc/*.cu`` source, and a
route's kernel reads its counter less the other route's. The wrappers'
refusals need no card. On the card: ``tests/test_torch_cuda.py``.
"""

import collections
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from h100bench.tracing import kernel_class
from instageo_tpu_torch.models.prithvi import Block, Mlp
from instageo_tpu_torch.ops import norm_act as na

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16


def _randn(shape, seed, dtype=BF16, scale=1.0, offset=0.0):
    g = torch.Generator().manual_seed(seed)
    return (offset + scale * torch.randn(shape, generator=g)).to(dtype)


def _ln_params(d, seed):
    return (1.0 + _randn((d,), seed, torch.float32, 0.1),
            _randn((d,), seed + 1, torch.float32, 0.1))


def _round_trip_block(block, x):
    """The block as it ran before the kernels: each norm in float32, cast back."""
    dt = x.dtype
    x = x + block.attn(F.layer_norm(x.float(), (x.shape[-1],), block.norm1.weight,
                                    block.norm1.bias, block.norm1.eps).to(dt))
    y = F.layer_norm(x.float(), (x.shape[-1],), block.norm2.weight, block.norm2.bias,
                     block.norm2.eps).to(dt)
    mlp = block.mlp
    h = F.linear(y, mlp.fc1.weight.to(dt), mlp.fc1.bias.to(dt))
    h = F.gelu(h.float(), approximate="none").to(h.dtype)
    return x + F.linear(h, mlp.fc2.weight.to(dt), mlp.fc2.bias.to(dt))


def _grads(fn, module, x, seed):
    x = x.detach().requires_grad_()
    module.zero_grad(set_to_none=True)
    out = fn(x)
    out.backward(_randn(out.shape, seed))
    return out.detach(), x.grad, {n: p.grad.clone() for n, p in module.named_parameters()}


@pytest.mark.parametrize("dim,heads,remat", [(64, 4, False), (256, 4, False), (64, 4, True)])
def test_block_on_cpu_bf16_is_the_float32_round_trip(dim, heads, remat):
    torch.manual_seed(dim)
    block = Block(dim, heads, dtype=BF16, remat=remat)
    x = _randn((2, 9, dim), 3, offset=0.5)
    got = _grads(block, block, x, 4)
    want = _grads(lambda t: _round_trip_block(block, t), block, x, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for name, g in want[2].items():
        assert torch.equal(got[2][name], g), name


@pytest.mark.parametrize("gelu", ["exact", "tanh", "bf16"])
def test_mlp_on_cpu_bf16_is_what_it_was(gelu):
    torch.manual_seed(1)
    mlp = Mlp(32, 128, dtype=BF16, gelu=gelu)
    approx = {"exact": "none", "tanh": "tanh"}

    def before(t):
        h = F.linear(t, mlp.fc1.weight.to(BF16), mlp.fc1.bias.to(BF16))
        h = F.gelu(h) if gelu == "bf16" else F.gelu(h.float(), approximate=approx[gelu]).to(BF16)
        return F.linear(h, mlp.fc2.weight.to(BF16), mlp.fc2.bias.to(BF16))

    x = _randn((3, 5, 32), 2, scale=2.0)
    got, want = _grads(mlp, mlp, x, 5), _grads(before, mlp, x, 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for name, g in want[2].items():
        assert torch.equal(got[2][name], g), name


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("shape", [(4, 7, 64), (13, 256)])
def test_layer_norm_op_on_cpu_is_the_plain_version(dtype, shape):
    """The op's forward and its registered backward give the plain versions
    bit for bit; ``layer_norm`` gives the float32 round trip."""
    w, b = _ln_params(shape[-1], 7)
    x = _randn(shape, 8, dtype, 2.0, 0.3)
    dy = _randn(shape, 9, dtype)
    y, mean, rstd = na.ln_rows_fwd_plain(x, w, b, 1e-5)
    assert y.dtype == dtype and mean.shape == rstd.shape == shape[:-1]
    assert torch.equal(y, F.layer_norm(x.float(), shape[-1:], w, b, 1e-5).to(dtype))
    assert torch.equal(na.layer_norm(x, w, b, 1e-5), y)
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    got = na.ln_rows_fwd_op(xr, wr, br, 1e-5)
    for a, want in zip(got, (y, mean, rstd)):
        assert torch.equal(a, want)
    got[0].backward(dy)
    dx, dw, db = na.ln_rows_bwd_plain(dy, x, mean, rstd, w)
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    assert torch.equal(xr.grad, dx) and torch.equal(wr.grad, dw) and torch.equal(br.grad, db)
    # The plain backward is autograd's through the float32 round trip.
    xa, wa, ba = (t.clone().requires_grad_() for t in (x, w, b))
    F.layer_norm(xa.float(), shape[-1:], wa, ba, 1e-5).to(dtype).backward(dy)
    assert torch.equal(xa.grad, dx) and torch.equal(wa.grad, dw) and torch.equal(ba.grad, db)


def _op_args(name):
    w, b = _ln_params(64, 1)
    x = _randn((3, 5, 64), 2)
    _, mean, rstd = na.ln_rows_fwd_plain(x, w, b, 1e-5)
    dy = _randn((3, 5, 64), 3)
    return {"ln_rows_fwd": (na.ln_rows_fwd_op, (x.requires_grad_(), w.requires_grad_(), b, 1e-5)),
            "ln_rows_bwd": (na.ln_rows_bwd_op, (dy, x.detach(), mean, rstd, w.detach()))}[name]


@pytest.mark.parametrize("name", ["ln_rows_fwd", "ln_rows_bwd"])
def test_custom_op_registrations_pass_opcheck(name):
    op, args = _op_args(name)
    result = torch.library.opcheck(
        op, args, test_utils=("test_schema", "test_faketensor", "test_autograd_registration"))
    assert set(result.values()) == {"SUCCESS"}, result


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket._qualified_op_name] += 1
        return func(*args, **(kwargs or {}))


def test_fake_versions_give_the_kernels_shapes_and_dtypes():
    with FakeTensorMode():
        x = torch.empty(4, 7, 768, dtype=BF16, device="cuda")
        w = torch.empty(768, device="cuda")
        y, mean, rstd = na.ln_rows_fwd_op(x, w, w, 1e-5)
        assert (y.shape, y.dtype, y.device.type) == (x.shape, BF16, "cuda")
        for s in (mean, rstd):
            assert (s.shape, s.dtype) == ((4, 7), torch.float32)
        dx, dw, db = na.ln_rows_bwd_op(x, x, mean, rstd, w)
        assert (dx.shape, dx.dtype) == (x.shape, BF16)
        assert dw.shape == db.shape == (768,) and dw.dtype == db.dtype == torch.float32


@pytest.mark.parametrize("device,dtype,routed", [("cuda", BF16, True),
                                                 ("cuda", torch.float32, False),
                                                 ("cpu", BF16, False)])
def test_bf16_cuda_tensors_dispatch_to_the_ops(device, dtype, routed):
    """What the model calls: a bf16 CUDA tensor goes to the custom ops, a
    float32 or CPU tensor to the plain version's aten ops."""
    ours = {"instageo_tpu_torch::ln_rows_fwd"}
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty(2, 5, 64, dtype=dtype, device=device)
        w = torch.empty(64, device=device)
        with _OpLog() as log:
            assert na.layer_norm(x, w, w, 1e-5).dtype == dtype
    assert (set(log.ops) >= ours) == routed
    assert not routed or "aten::native_layer_norm" not in log.ops
    assert routed or not ours & set(log.ops)


class _DtypeLog(TorchDispatchMode):
    """Each op's name with the dtypes of its tensor arguments."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dtypes = tuple(a.dtype for a in args if isinstance(a, torch.Tensor))
        self.calls.append((func.overloadpacket._qualified_op_name, dtypes))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("gelu,one_bf16_gelu", [("exact", True), ("bf16", True),
                                                ("tanh", False)])
def test_mlp_gelu_on_a_card_tensor(gelu, one_bf16_gelu):
    """On a (fake) CUDA bf16 tensor, ``exact`` and ``bf16`` are one GELU on
    the bf16 tensor with no float32 cast (CUDA's GELU computes in float32
    and rounds once, as the round trip does; autograd saves the bf16 input
    for its backward); ``tanh`` keeps its float32 round trip. Without
    autograd: a CPU build cannot record fake CUDA ops."""
    mlp = Mlp(32, 128, dtype=BF16, gelu=gelu)
    with FakeTensorMode():
        for name, p in list(mlp.named_parameters()):
            layer, attr = name.split(".")
            setattr(getattr(mlp, layer), attr,
                    torch.nn.Parameter(torch.empty(p.shape, device="cuda"), requires_grad=False))
        x = torch.empty(3, 5, 32, dtype=BF16, device="cuda")
        with _DtypeLog() as log:
            assert mlp(x).dtype == BF16
    want = BF16 if one_bf16_gelu else torch.float32
    assert [dtypes for name, dtypes in log.calls if name == "aten::gelu"] == [(want,)]
    # The forward's only cast of a bf16 tensor is the round trip's.
    up = [c for c in log.calls if c[0] == "aten::_to_copy" and c[1] == (BF16,)]
    assert len(up) == (0 if one_bf16_gelu else 1), up


def test_training_launch_counts_name_the_layer_norm_kernels():
    """``utils/telemetry.py:kernel_launches`` (the training CLI's
    ``train_launches``, the walkthroughs' counts) names both LayerNorm
    kernels beside the other Hopper kernels; none launch on the CPU."""
    from instageo_tpu_torch.utils.telemetry import kernel_launches

    before = kernel_launches()
    assert {"ln_rows_bf16_fwd", "ln_rows_bf16_bwd", "fused_dropout"} <= set(before)
    block = Block(64, 4, dtype=BF16)
    block(_randn((2, 9, 64), 1)).float().sum().backward()
    assert kernel_launches() == before


def test_kernel_table_covers_every_source():
    """Each ``csrc/*.cu`` that ``_build.sources()`` builds is the source of
    a kernel of ``ops.kernels()`` (declared in its module's ``KERNELS``),
    and each kernel's source is one of them."""
    from instageo_tpu_torch.ops import _build, kernels

    table = kernels()
    assert all(name == k.name for name, k in table.items())
    assert {k.source for k in table.values()} == set(_build.sources())


@pytest.mark.parametrize("field,want", [("count", 3), ("captured", 2), ("replayed", 4),
                                        ("total", 7)])
def test_a_route_reads_its_counter_less_the_other_route(field, want):
    """``Kernel.read``: the wgmma route's launches are its counter's (both
    routes) less the mma.sync route's, made directly, captured into a graph
    or replayed; ``total`` is direct plus replayed."""
    from instageo_tpu_torch.ops._build import Kernel, LaunchCounter

    both, other = LaunchCounter(), LaunchCounter()
    both.count, both.captured, both.replayed = 5, 3, 6
    other.count, other.captured, other.replayed = 2, 1, 2
    assert Kernel("k", "k", both, less=other).read(field) == want
    assert Kernel("k", "k", other).read(field) == {"count": 2, "captured": 1, "replayed": 2,
                                                  "total": 4}[field]


def _global_kernels() -> list:
    src = (ROOT / "instageo_tpu_torch" / "ops" / "csrc" / "norm_act.cu").read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\)?\s*)?(\w+)\s*\(",
                      src)


def test_kernel_symbols_count_as_elementwise_work():
    """Each kernel of ``csrc/norm_act.cu``, by the name the profiler gives
    it, falls in ``h100bench.tracing.kernel_class``'s "other" class, which
    ``eltwise_ms_per_chip`` reads."""
    names = _global_kernels()
    assert sorted(names) == ["ln_rows_bf16_bwd", "ln_rows_bf16_bwd_colsum", "ln_rows_bf16_fwd"]
    for name in names:
        for shown in (name, f"void (anonymous namespace)::{name}<3>(uint4 const*, float const*, "
                            "float const*, uint4*, float*, float*, long long, int, float)",
                      f"void (anonymous namespace)::{name}(float const*, float*, float*, "
                      "int, int)"):
            assert kernel_class(shown) == "other", shown


@pytest.mark.parametrize("d,ok", [(8, True), (256, True), (768, True), (1280, True),
                                  (2048, True), (0, False), (12, False), (2056, False)])
def test_row_kernels_take_widths_of_whole_vectors(d, ok):
    if ok:
        na.check_width(d)
    else:
        with pytest.raises(ValueError, match="multiples of 8"):
            na.check_width(d)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 64, dtype=BF16)
    assert na._bf16("x", x, x.device) is x
    assert na._bf16("x", x[::2], x.device).is_contiguous()
    with pytest.raises(TypeError, match="bfloat16"):
        na._bf16("x", x.half(), x.device)
    with pytest.raises(ValueError, match="last dim"):
        na._bf16("x", x.t(), x.device)
    with pytest.raises(ValueError, match="16-byte"):
        na._bf16("x", torch.zeros(257, dtype=BF16)[1:].view(4, 64), x.device)
    with pytest.raises(ValueError, match="float32"):
        na._param("weight", torch.zeros(64, dtype=BF16), 64, x.device)
    with pytest.raises(ValueError, match="float32"):
        na._param("weight", torch.zeros(32), 64, x.device)
    odd = torch.zeros(65)[1:]
    assert odd.data_ptr() % 16 and na._param("bias", odd, 64, x.device).data_ptr() % 16 == 0
