"""The yardstick's counts against hand formulas, and the readers over a
made-up summary."""

import json

import pytest

from h100bench import counts, layers, tracing
from h100bench.common import Context, reference_module
from h100bench.tests import tiny


def test_attention_counts():
    b, h, l, d = 64, 12, 589, 64
    flops, nbytes = counts.attention_fwd(b, h, l, d)
    assert flops == 4 * b * h * l * l * d
    assert nbytes == 2 * (4 * b * h * l * d) + 4 * b * h * l
    flops, nbytes = counts.attention_bwd(b, h, l, d)
    assert flops == 10 * b * h * l * l * d
    assert nbytes == 16 * b * h * l * d + 4 * b * h * l


def test_dropout_counts_four_bytes_per_bf16_element():
    assert counts.dropout(1000) == (0.0, 4000.0)
    assert counts.bound_s(*counts.dropout(1000)) == pytest.approx(4000 / 3.35e12)


def test_bound_and_share():
    assert counts.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert counts.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert counts.share_pct(1.0, 4.0) == 25.0
    assert counts.share_pct(1.0, 0.0) is None


def _hand_flops(m):
    """Matmul and convolution FLOPs of one chip's forward, by hand."""
    d, l, hid = m["embed_dim"], None, int(m["embed_dim"] * m["mlp_ratio"])
    pt, ph, pw = m["patch_size"]
    t, s = m["num_frames"] // pt, m["img_size"] // ph
    n = t * s * s
    l = n + 1
    f = 2 * n * d * m["in_chans"] * pt * ph * pw                      # patch embedding
    f += m["depth"] * (2 * l * d * (3 * d + d + 2 * hid) + 4 * l * l * d)
    ch = [d * t // 2 ** i for i in range(5)]
    side = s
    for i, k in enumerate(m["head_kernels"]):
        f += 2 * side * side * ch[i] * ch[i + 1] * 9                   # ConvTranspose2d
        side *= 2
        out = side + 2 - k + 1
        f += 2 * out * out * ch[i + 1] * ch[i + 1] * k * k             # Conv2d
        side = out
    return f + 2 * side * side * ch[4] * m["num_classes"]             # classifier


@pytest.mark.parametrize("config", ["v1_100m_crop", "v2_600m"])
def test_model_flops_match_hand_count(config):
    cfg = json.loads((tiny.BENCH / "configs" / f"{config}.json").read_text())
    ref = reference_module(cfg)
    assert ref.flops_per_chip(cfg["model"]) == pytest.approx(_hand_flops(cfg["model"]), rel=1e-9)


@pytest.mark.parametrize("config,length", [("v1_100m_crop", 589), ("v2_600m", 257)])
def test_sequence_lengths(config, length):
    cfg = json.loads((tiny.BENCH / "configs" / f"{config}.json").read_text())
    assert reference_module(cfg).tokens(cfg["model"]) == length


def _ctx(config, traffic):
    import torch

    cfg = json.loads((tiny.BENCH / "configs" / f"{config}.json").read_text())
    tr = json.loads((tiny.BENCH / "traffic" / f"{traffic}.json").read_text())
    return Context(cell="x", config=cfg, traffic=tr, limits={}, seed=1, seconds=1,
                   trace=True, device=torch.device("cpu"), t_process=0.0)


def test_readers_over_a_made_up_summary():
    from h100bench.harness import metric_reader

    ctx = _ctx("v1_100m_crop", "train_b8")
    b, h, l, d = layers.attention_shape(ctx)
    assert (b, h, l, d) == (8, 12, 589, 64)
    fwd = counts.bound_s(*counts.attention_fwd(b, h, l, d))
    bwd = counts.bound_s(*counts.attention_bwd(b, h, l, d))
    numel = sum(x * y * z * w for x, y, z, w in
                reference_module(ctx.config).dropout_shapes(ctx.config["model"], 8))
    summary = {
        "busy_s": 0.9, "window_s": 1.0, "idle": {},
        "kernels": {"flash_attn_fwd_sm90_kernel": [12, 12 * fwd * 2],
                    "flash_attn_bwd_sm90_kernel": [12, 12 * bwd * 4],
                    "fused_dropout_kernel<bf16>": [5, 4 * numel / 3.35e12 * 2],
                    "multi_tensor_apply_kernel<adam>": [3, 0.003],
                    "nvjet_tst_gemm": [10, 0.2],
                    "vectorized_elementwise_kernel": [100, 0.08]},
        "memcpy": {"Memcpy HtoD (Pinned -> Device)": 0.004, "Memcpy DtoD": 1.0},
        "units": {"chips": 8, "steps": 1, "attn_fwd_calls": 12, "attn_bwd_calls": 12,
                  "dropout_calls": 5}}
    read = lambda name: metric_reader(tiny.ROOT, name)(summary, ctx, name)  # noqa: E731
    assert read("idle_pct.train") == pytest.approx(10.0)
    assert read("attn_fwd_roofline.train") == pytest.approx(50.0)
    assert read("attn_bwd_roofline.train") == pytest.approx(25.0)
    assert read("dropout_roofline.train") == pytest.approx(50.0)
    assert read("adamw_ms_per_step.train") == pytest.approx(3.0)
    assert read("eltwise_ms_per_chip.train") == pytest.approx(10.0)
    assert read("copy_ms_per_chip.train") == pytest.approx(0.5)
    flops = reference_module(ctx.config).flops_per_chip(ctx.config["model"])
    assert read("mfu.train") == pytest.approx(100 * 3 * flops * 8 / 989e12)
    # Nothing to read: no value, never a 0 share.
    empty = dict(summary, kernels={}, units={"chips": 8, "steps": 1})
    for name in ("attn_fwd_roofline.train", "attn_bwd_roofline.train",
                 "dropout_roofline.train", "adamw_ms_per_step.train"):
        assert metric_reader(tiny.ROOT, name)(empty, ctx, name) is None


def test_kernel_classes():
    assert tracing.kernel_class("flash_attn_fwd_sm90_kernel") == "attn_fwd"
    assert tracing.kernel_class("flash_attn_bwd_sm90_dq_kernel") == "attn_bwd"
    assert tracing.kernel_class("void fused_dropout_kernel<bf16>") == "dropout"
    assert tracing.kernel_class("sm90_xmma_fprop_implicit_gemm_bf16") == "convolution"
    assert tracing.kernel_class("nvjet_tst_192x192") == "matmul"
    assert tracing.kernel_class("multi_tensor_apply_kernel") == "optimizer"
    assert tracing.kernel_class("vectorized_elementwise_kernel<GeluCUDAKernelImpl>") == "other"


def test_summarize_busy_idle_and_labels():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 50.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "ts": 400.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 505.0, "dur": 95.0},
        {"ph": "X", "cat": "user_annotation", "name": "bench.predict", "ts": 140.0, "dur": 300.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 200.0, "dur": 150.0},
    ]
    s = tracing.summarize(ev)
    assert s["window_s"] == pytest.approx(600e-6)
    assert s["busy_s"] == pytest.approx(345e-6)
    assert s["kernels"]["a"] == [2, pytest.approx(195e-6)]
    assert s["idle"]["bench.predict / aten::copy_"] == pytest.approx(250e-6)
    assert s["idle"][tracing.SMALL_GAP_LABEL] == pytest.approx(5e-6)
