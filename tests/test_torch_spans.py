"""The port's profiler spans (``utils/telemetry.py:span``) and their
reading from a Chrome trace (``tools/trace_spans.py``), on the CPU.

* With no profiler running, ``span`` hands back one shared null context,
  and the exported serving program holds no profiler node.
* Under a CPU profile, the fused predict runs its five spans once each, in
  order, inside the caller's range; a grouped train epoch runs its group
  spans (host batches, seeds, stage, then the replay or, for the first
  group of a captured trainer, the capture with its plain steps), the
  tail's plain step and the read-back.
* ``tools/trace_spans.py`` on a synthetic Chrome trace gives each span the
  device time of the operations launched inside it (by correlation,
  inclusively, a graph launch owning all its kernels, another thread's
  launches not), credits each idle gap to the innermost span and names the
  gap by its ``bench.*`` and program span, gives each cell's coverage
  of the device-op seconds by its top-level spans, and passes on the
  summary's memcpy seconds by kind.
* The benchmark's own summary (``h100bench/tracing.py:summarize``) reads
  the same numbers with and without the program's spans in the trace.
* Telemetry, the span tool and the card smoke run (``chip_smoke.py``) read
  each kernel's launches from the one table (``ops.kernels()``), under
  telemetry's names; the smoke's expected launches come from the model's
  structure (depth, head dim, compute dtype, the head's dropouts).
"""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from h100bench import tracing
from h100bench.common import load_module
from instageo_tpu_torch.models.seg import create_prithvi_seg
from instageo_tpu_torch.ops.preprocess import make_fused_predict_fn
from instageo_tpu_torch.serve.export import export_predict
from instageo_tpu_torch.train import trainer as trainer_mod
from instageo_tpu_torch.train.trainer import Trainer
from instageo_tpu_torch.utils import telemetry

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SERVE_SPANS = ["instageo.serve.upload", "instageo.serve.preprocess", "instageo.model.encoder",
               "instageo.model.head", "instageo.serve.argmax"]
trace_spans = load_module(ROOT / "tools" / "trace_spans.py", "trace_spans")
chip_smoke = load_module(ROOT / "chip_smoke.py", "chip_smoke")
# ``utils/telemetry.py:kernel_launches``'s keys, which users read in the
# quickstart's JSON, ``train_launches`` and the multichip walkthrough.
KERNEL_NAMES = ["flash_attn_fwd_sm90", "flash_attn_fwd", "flash_attn_bwd_sm90", "flash_attn_bwd",
                "fused_dropout", "ln_rows_bf16_fwd", "ln_rows_bf16_bwd"]


def _tiny(num_classes=3, param_dtype=None):
    return create_prithvi_seg("prithvi_eo_tiny", depth=2, image_size=32, num_bands=6,
                              num_classes=num_classes, param_dtype=param_dtype,
                              device="cpu", seed=0)


def _events(prof, tmp_path):
    """The profile's exported Chrome trace events."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def _ranges(events, prefix):
    """(name, start, end) of the host ranges named ``prefix*``, by start."""
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith(prefix)]
    return sorted(out, key=lambda r: r[1])


def test_span_is_one_null_context_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = telemetry.span("instageo.a"), telemetry.span("instageo.b")
    assert first is second
    assert isinstance(first, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(telemetry.span("instageo.a"), record_function)
    assert telemetry.span("instageo.a") is first


def test_exported_program_has_no_profiler_node(tmp_path):
    model = _tiny()
    export_predict(model, str(tmp_path / "predict.pt2"), num_bands=6, img_size=32)
    program = torch.export.load(str(tmp_path / "predict.pt2"))
    targets = [str(node.target) for node in program.graph.nodes]
    assert any("flash_attn_fwd" in t for t in targets)
    assert not [t for t in targets if "profiler" in t or "record_function" in t]


@pytest.mark.parametrize("is_reg_task", [False, True])
def test_serving_spans_nest_in_order(tmp_path, is_reg_task):
    model = _tiny(num_classes=1 if is_reg_task else 3)
    predict = make_fused_predict_fn(model, [1000.0] * 6, [500.0] * 6, is_reg_task=is_reg_task)
    raw = np.random.default_rng(0).integers(0, 3000, size=(2, 6, 32, 32)).astype(np.uint16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.predict"):
            out = predict(raw)
    assert out.shape == (2, 32, 32)
    events = _events(prof, tmp_path)
    (_, outer_start, outer_end), = _ranges(events, "test.")
    spans = _ranges(events, "instageo.")
    assert [name for name, _, _ in spans] == SERVE_SPANS
    for (_, start, end), (_, next_start, _) in zip(spans, spans[1:] + [(None, outer_end, 0)]):
        assert outer_start <= start <= end <= next_start <= outer_end


class _ReplayedFn:
    """A stand-in for ``CapturedGraph`` on the CPU: capture records ``fn``,
    each replay runs it (what the graph's replay computes)."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.mark.parametrize("captured", [False, True])
def test_grouped_epoch_spans(tmp_path, monkeypatch, captured):
    """5 batches at k = 2: two groups and a tail of one plain step. A
    captured trainer's first group is the capture (its two plain steps
    inside), its second a replay."""
    cfg = {"train": {"learning_rate": 1e-3, "weight_decay": 0.01, "ignore_index": -1,
                     "batch_size": 4}, "model": {"num_classes": 2},
           "tpu": {"steps_per_call": 2}}
    trainer = Trainer(cfg, _tiny(num_classes=2, param_dtype=torch.float32), device="cpu")
    if captured:
        monkeypatch.setattr(trainer_mod, "CapturedGraph", _ReplayedFn)
        trainer.capture = True
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(4, 6, 1, 32, 32)).astype(np.float32),
                rng.integers(-1, 2, size=(4, 32, 32)).astype(np.int64)) for _ in range(5)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = trainer.run_train_epoch(iter(batches), torch.Generator().manual_seed(7), 4)
    assert np.isfinite(out["train_loss"]) and trainer.step == 5
    events = _events(prof, tmp_path)
    spans = _ranges(events, "instageo.train.")
    names = [n.removeprefix("instageo.train.") for n, _, _ in spans]
    group = ["host_batch", "seeds", "stage", "replay"]
    first = ["host_batch", "capture", "plain_step", "plain_step"] if captured else group
    assert names == first + group + ["plain_step", "finalize"]
    if captured:
        (_, cs, ce), = [r for r in spans if r[0] == "instageo.train.capture"]
        inside = [n for n, s, e in spans if cs <= s and e <= ce and n != "instageo.train.capture"]
        assert inside == ["instageo.train.plain_step"] * 2
    model_spans = _ranges(events, "instageo.model.")
    assert len(model_spans) == 2 * 5   # one encoder and one head span per step


# --------------------------------------------------------------------------
# tools/trace_spans.py on a synthetic Chrome trace (times in microseconds)
# --------------------------------------------------------------------------

MAIN, OTHER = (1, 1), (1, 2)


def _x(cat, name, ts, dur, thread=MAIN, corr=None, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": thread[0], "tid": thread[1]}
    if corr is not None:
        e["args"] = dict(args, correlation=corr)
    return e


def _trace():
    """One request of a server and one replayed group, on the main thread;
    a loader thread launches a copy while the upload span is open. The head
    span nests in the encoder's here, to show the count is inclusive."""
    host = [
        _x("user_annotation", "bench.predict", 0, 1000),
        _x("user_annotation", "instageo.serve.upload", 10, 90),
        _x("cpu_op", "aten::copy_", 15, 80),
        _x("cuda_runtime", "cudaMemcpyAsync", 20, 5, corr=1),
        _x("user_annotation", "instageo.model.encoder", 100, 300),
        _x("cpu_op", "aten::linear", 105, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 4, corr=2),
        _x("user_annotation", "instageo.model.head", 300, 90),
        _x("cuda_driver", "cuLaunchKernelEx", 310, 4, corr=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 30, 4, thread=OTHER, corr=9),
        _x("user_annotation", "instageo.train.replay", 1100, 600),
        _x("cuda_runtime", "cudaGraphLaunch", 1110, 8, corr=4),
        _x("user_annotation", "instageo.train.stage", 1700, 200),
        _x("cpu_op", "aten::copy_", 1710, 150),
    ]
    dev = [
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 30, 60, (0, 7), corr=1),
        _x("kernel", "gemm_a", 120, 80, (0, 7), corr=2),
        _x("kernel", "conv_b", 330, 40, (0, 7), corr=3),
        _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 380, 10, (0, 8), corr=9),
        _x("kernel", "graph_k1", 1120, 100, (0, 7), corr=4),
        _x("kernel", "graph_k2", 1230, 100, (0, 7), corr=4),
        _x("gpu_memset", "Memset (Device)", 1335, 5, (0, 7), corr=4),
        _x("kernel", "graph_k3", 1400, 200, (0, 7), corr=4),
    ]
    return host + dev


def test_span_table_attributes_device_time_to_spans():
    spans = trace_spans.span_table(_trace())
    assert {n: r["count"] for n, r in spans.items()} == {
        "instageo.serve.upload": 1, "instageo.model.encoder": 1, "instageo.model.head": 1,
        "instageo.train.replay": 1, "instageo.train.stage": 1}
    device = {n: round(r["device_s"] * 1e6, 6) for n, r in spans.items()}
    # The loader thread's copy (correlation 9) lies in the upload's time
    # but not on its thread; the head nests in the encoder, which owns it too.
    assert device == {"instageo.serve.upload": 60, "instageo.model.encoder": 120,
                      "instageo.model.head": 40, "instageo.train.replay": 405,
                      "instageo.train.stage": 0}
    assert round(spans["instageo.model.encoder"]["host_s"] * 1e6, 6) == 300
    assert set(trace_spans.span_table(_trace(), "bench.")) == {"bench.predict"}


def test_idle_gaps_go_to_the_innermost_span():
    in_span, by_phase = trace_spans.idle_by_span(_trace())
    # Gaps (middle): 90-120 (105: the upload closed at 100, the encoder's),
    # 200-330 (265: encoder), 370-380 (375: the head, inside the encoder),
    # 390-1120 (755: no program span), 1220-1230, 1330-1335 and 1340-1400
    # (replay, outside any bench.* span).
    assert {n: round(v * 1e6, 6) for n, v in in_span.items()} == {
        "instageo.model.encoder": 30 + 130, "instageo.model.head": 10,
        "instageo.train.replay": 10 + 5 + 60}
    assert {n: round(v * 1e6, 6) for n, v in by_phase.items()} == {
        "bench.predict / instageo.model.encoder": 30 + 130,
        "bench.predict / instageo.model.head": 10,
        "bench.predict": 730,
        "instageo.train.replay": 10 + 5 + 60}


def _serving_request():
    """One request whose five serving spans run one after another, then the
    harness's copy back; a loader thread's copy belongs to no span."""
    host = [_x("user_annotation", "bench.predict", 0, 600)]
    dev = []
    for i, name in enumerate(trace_spans.SERVE_TOP):
        host += [_x("user_annotation", name, 100 * i, 90),
                 _x("cuda_runtime", "cudaLaunchKernel", 100 * i + 5, 4, corr=i)]
        dev.append(_x("kernel", f"k{i}", 100 * i + 10, 10 * (i + 1), (0, 7), corr=i))
    host += [_x("user_annotation", "bench.copy_back", 600, 50),
             _x("cuda_runtime", "cudaMemcpyAsync", 605, 4, corr=10),
             _x("cuda_runtime", "cudaMemcpyAsync", 200, 4, thread=OTHER, corr=11)]
    dev += [_x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 610, 50, (0, 7), corr=10),
            _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 660, 50, (0, 8), corr=11)]
    return host + dev, (150 + 50) / (150 + 50 + 50)


def _training_group():
    """Seeds, a stage and a replay of a graph whose kernels carry a graph
    node id; every device operation is owned."""
    host = [_x("user_annotation", "instageo.train.seeds", 0, 50),
            _x("cuda_runtime", "cudaMemcpyAsync", 10, 4, corr=1),
            _x("user_annotation", "instageo.train.stage", 50, 50),
            _x("cuda_runtime", "cudaMemcpyAsync", 60, 4, corr=2),
            _x("user_annotation", "instageo.train.replay", 100, 500),
            _x("cuda_runtime", "cudaGraphLaunch", 110, 8, corr=3)]
    dev = [_x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 20, 10, (0, 7), corr=1),
           _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 70, 20, (0, 7), corr=2),
           _x("kernel", "graph_k1", 120, 100, (0, 7), corr=3, graph_node=11),
           _x("kernel", "graph_k2", 230, 100, (0, 7), corr=3, graph_node=12)]
    return host + dev, 1.0


@pytest.mark.parametrize("make", [_serving_request, _training_group])
def test_describe_gives_each_cell_its_coverage(make):
    events, share = make()
    summary = tracing.summarize(events)
    out = trace_spans.describe(events, summary)
    assert out["coverage"]["share"] == pytest.approx(share)
    assert out["memcpy"] == summary["memcpy"] and out["memcpy"]
    graph = out["graph_kernel_args"]
    if make is _training_group:
        assert set(out["coverage"]["parts"]) == set(trace_spans.TRAIN_TOP)
        assert graph == {"kernels": 2, "keys": ["correlation", "graph_node"],
                         "with_graph_node": 2}
    else:
        assert set(out["coverage"]["parts"]) == set(trace_spans.SERVE_TOP) | {"bench.copy_back"}
        assert graph["kernels"] == 0


@pytest.mark.parametrize("drop", ["instageo.", "instageo.train."])
def test_benchmark_summary_is_blind_to_program_spans(drop):
    """The harness's summary of a trace with and without the program's
    ranges: every number the same, so the parent's program and this one
    read alike."""
    full = _trace()
    bare = [e for e in full if not (e["cat"] == "user_annotation"
                                    and e["name"].startswith(drop))]
    assert tracing.summarize(full) == tracing.summarize(bare)


# The table of the port's kernels and what reads it


@pytest.mark.parametrize("read", [telemetry.kernel_launches,
                                  trace_spans.COUNTER_GROUPS["launch_counters"],
                                  chip_smoke.read_counts],
                         ids=["telemetry", "trace_spans", "chip_smoke"])
def test_launch_readers_take_the_kernel_table(read):
    """Each reader gives ``ops.launch_counts()``: the table's names, in its
    order, with a forward on the mma.sync route counted there and not on
    the wgmma route (whose counter counts both)."""
    from instageo_tpu_torch.ops import attention, kernels, launch_counts

    before = read()
    assert list(before) == list(kernels()) == KERNEL_NAMES
    attention.launches.add(3)
    attention.fwd_mma_launches.add(1)
    try:
        after = read()
        assert after == launch_counts()
        assert {k: n - before[k] for k, n in after.items() if n != before[k]} == {
            "flash_attn_fwd_sm90": 2, "flash_attn_fwd": 1}
    finally:
        attention.launches.add(-3)
        attention.fwd_mma_launches.add(-1)


def test_smoke_resets_and_reads_every_counter_of_the_table():
    """``chip_smoke.reset_counts`` sets every kernel's launches to 0, and
    ``read_graph_counts`` reads every kernel's captured and replayed
    launches."""
    from instageo_tpu_torch.ops import kernels

    for k in kernels().values():
        k.counter.add(2)
        k.counter.add_replayed(1)
    graphs = chip_smoke.read_graph_counts()
    assert list(graphs["captured"]) == list(graphs["replayed"]) == KERNEL_NAMES
    chip_smoke.reset_counts()
    graphs = chip_smoke.read_graph_counts()
    zeros = dict.fromkeys(KERNEL_NAMES, 0)
    assert chip_smoke.read_counts() == graphs["captured"] == graphs["replayed"] == zeros


@pytest.mark.parametrize("dtype,head_impl,head_dim,runs,want", [
    (torch.bfloat16, "torch", 64, dict(forwards=1),
     dict(flash_attn_fwd_sm90=2, ln_rows_bf16_fwd=4)),
    (torch.bfloat16, "torch", 64, dict(forwards=3, backwards=2),
     dict(flash_attn_fwd_sm90=6, flash_attn_bwd_sm90=4, ln_rows_bf16_fwd=12,
          ln_rows_bf16_bwd=8, fused_dropout=10)),
    (torch.bfloat16, "torch", 64, dict(forwards=2, plain_forwards=1),
     dict(flash_attn_fwd_sm90=4, ln_rows_bf16_fwd=12)),
    (torch.bfloat16, "torch", 32, dict(forwards=1, backwards=1),
     dict(flash_attn_fwd=2, flash_attn_bwd=2, ln_rows_bf16_fwd=4, ln_rows_bf16_bwd=4,
          fused_dropout=5)),
    (torch.bfloat16, "fast", 64, dict(forwards=1, backwards=1),
     dict(flash_attn_fwd_sm90=2, flash_attn_bwd_sm90=2, ln_rows_bf16_fwd=4,
          ln_rows_bf16_bwd=4, fused_dropout=4)),
    (torch.float32, "torch", 64, dict(forwards=3, plain_forwards=1), {}),
    (torch.float32, "torch", 64, dict(forwards=2, backwards=2), dict(fused_dropout=10)),
])
def test_expected_launches_follow_the_model(dtype, head_impl, head_dim, runs, want):
    """``chip_smoke.expected_launches`` on the tiny model (depth 2): per
    bf16 block forward one attention forward on its head dim's route and
    two LayerNorm forwards, per block backward one attention backward and
    two LayerNorm backwards, per trained forward one launch per drawing
    dropout of the head (5, the fast head's 4); a float32 model launches
    only its dropouts."""
    model = create_prithvi_seg("prithvi_eo_tiny", depth=2, image_size=32, num_bands=6,
                               dtype=dtype, head_impl=head_impl, device="cpu", seed=0)
    for block in model.prithvi_encoder.blocks:
        block.attn.head_dim = head_dim  # the structure the routes are read from
    assert chip_smoke.expected_launches(model, **runs) == dict(dict.fromkeys(KERNEL_NAMES, 0),
                                                                **want)
