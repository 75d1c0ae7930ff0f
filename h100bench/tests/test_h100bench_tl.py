"""The ``_tl`` serving cell loads by name, and the four-card training kind
with its traffic, limits and reader (built, its cell not yet listed); a
tiny ``_tl`` serving cell runs on the CPU (a test-only ``_tl`` variant of
``prithvi_eo_tiny``'s widths, patch 14, the 600M head's k5/k7 kernels, T=2,
56 px), is correct with its coords and not correct without them or with
the reference's float8 in the program's place."""

import json
import re
import shutil

import pytest

from h100bench import harness, readings
from h100bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
TL_CELL = "v2_600m_tl_crop.serve_b64"


@pytest.fixture
def tiny_tl_variant(monkeypatch):
    from instageo_tpu_torch.models import registry

    arch = registry.PRITHVI_ARCHS["prithvi_eo_tiny"].replace(
        num_frames=2, patch_size=(1, 14, 14), depth=2,
        coords_encoding=("time", "location"), coords_scale_learn=True)
    monkeypatch.setitem(registry.PRITHVI_ARCHS, "tiny_tl", arch)
    monkeypatch.setitem(registry.SEG_HEAD_KERNEL_SIZES, "tiny_tl", (5, 5, 5, 7))
    return "tiny_tl"


def make_tl(dst):
    """``tiny.make``'s copy with the cell ``tiny_tl.serve`` added."""
    root = tiny.make(dst)
    b = root / "h100bench"
    cfg = json.loads((b / "configs" / "v2_600m_tl_crop.json").read_text())
    t = 2
    cfg["name"] = "tiny_tl"
    cfg["model"].update(embed_dim=256, depth=2, num_heads=4, num_frames=t, img_size=56)
    raw = cfg["raw_chips"]
    raw.update(bands=6 * t, size=60, dn_mean=raw["dn_mean"][:6 * t], dn_std=raw["dn_std"][:6 * t])
    cfg["program"]["model"].update(model_name="tiny_tl", depth=2)
    cfg["program"]["dataloader"].update(bands=list(range(6 * t)), img_size=56, temporal_dim=t)
    (b / "configs" / "tiny_tl.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic" / "serve_tl_b64.json").read_text())
    traffic.update(batch=4, pool=3, warmup_requests=1, check_pool_batches=2,
                   trace_requests=[2, 3], calibration_chips=4)
    (b / "traffic" / "tiny_tl_serve.json").write_text(json.dumps(traffic))
    shutil.copy(b / "limits" / f"{TL_CELL}.json", b / "limits" / "tiny_tl.serve.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny_tl.serve", "config": "tiny_tl",
                               "traffic": "tiny_tl_serve", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if TL_CELL in m.get("workloads", []):
            m["workloads"].append("tiny_tl.serve")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_tl(tmp_path_factory.mktemp("bench_tl"))


def test_new_cells_load_by_name():
    bench = harness.load_benchmark(tiny.ROOT)
    files = harness.cell_files(tiny.ROOT, harness.find_cell(bench, TL_CELL))
    assert files["traffic"]["kind"] == "serve_closed_tl"
    assert files["config"]["reference"] == "prithvi_seg_tl" and files["limits"]
    module = harness.kind_module(tiny.ROOT, "serve_closed_tl")
    assert callable(module.run) and module.CONTROLS
    names = [m["name"] for m in harness.metrics_for(bench, "per_layer", TL_CELL)]
    assert "conv_roofline.serve" in names
    assert all(harness.metric_reader(tiny.ROOT, n) is not None for n in names), names


def test_benchmark_entries_keep_the_contract():
    bench = harness.load_benchmark(tiny.ROOT)
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[section]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names), section
    for cell in bench["workloads"]:
        assert 1 <= len(cell["why"]) <= 200 and "\n" not in cell["why"], cell["name"]
    assert sum(c["chips"] == 4 for c in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    for cfg in bench["configs"]:
        assert 1 <= len(cfg["why"]) <= 200 and (tiny.ROOT / cfg["file"]).exists()
    cells = {c["name"] for c in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]


def test_reference_embeds_the_published_sincos():
    """ω_i = 1/10000^(2i/d) over half the width each: year and day of
    year per frame, latitude and longitude per chip, times the scales."""
    import torch

    from h100bench.reference import prithvi_seg_tl as tl

    p = {name: torch.tensor([0.5]) for name in tl.SCALES}
    tc = torch.tensor([[[2020.0, 100.0], [2021.0, 200.0]]])
    lc = torch.tensor([[40.0, -100.0]])
    d = 8
    emb = tl.temporal_embed(p, d, tc)
    omega = 1.0 / 10000 ** (torch.arange(2) / 2.0)
    want = torch.cat([torch.sin(2021.0 * omega), torch.cos(2021.0 * omega),
                      torch.sin(200.0 * omega), torch.cos(200.0 * omega)])
    torch.testing.assert_close(emb[0, 1], 0.5 * want)
    loc = tl.location_embed(p, d, lc)
    want = torch.cat([torch.sin(40.0 * omega), torch.cos(40.0 * omega),
                      torch.sin(-100.0 * omega), torch.cos(-100.0 * omega)])
    torch.testing.assert_close(loc[0, 0], 0.5 * want)


def test_head_convs_are_the_counted_flops():
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from h100bench.reference import prithvi_seg_tl as tl

    m = json.loads((tiny.BENCH / "configs" / "v2_600m_tl_crop.json").read_text())["model"]
    p = {n: torch.empty(s, dtype=torch.int64 if i[0] == "count" else torch.float32,
                        device="meta") for n, s, i in tl.param_spec(m)}
    tok = torch.empty((2, tl.tokens(m), m["embed_dim"]), device="meta")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        tl.head(p, tok, m)
    assert sum(f for f, _ in tl.head_convs(m, 2)) == counter.get_total_flops()
    assert len(tl.head_convs(m, 2)) == 2 * len(m["head_kernels"]) + 1


def _coords_dropped(monkeypatch):
    from instageo_tpu_torch.ops import preprocess

    real = preprocess.make_fused_predict_fn

    def make(*args, **kw):
        predict = real(*args, **kw)
        return lambda raw, *coords: predict(raw)
    monkeypatch.setattr(preprocess, "make_fused_predict_fn", make)


@pytest.mark.parametrize("fault", [None, _coords_dropped], ids=["program", "coords_dropped"])
def test_tl_serving_cell(root, capsys, monkeypatch, tiny_tl_variant, fault):
    from instageo_tpu_torch.models import prithvi

    if fault is not None:
        fault(monkeypatch)
    embeds, missing = prithvi.coord_embeds.count, prithvi.coords_missing.count
    rc, line = tiny.run(root, "tiny_tl.serve", capsys=capsys)
    assert rc == 0
    assert line["correct"] is (fault is None), line["check"]
    assert set(line["metrics"]) == {"serve_chips_per_s", "serve_p95_ms", "peak_gib", "setup_s"}
    if fault is None:
        assert prithvi.coord_embeds.count > embeds and prithvi.coords_missing.count == missing
    else:
        assert prithvi.coords_missing.count > missing


def test_tl_stand_ins_fail(root, monkeypatch, tiny_tl_variant):
    readings.CONTROLS.setdefault("serve_closed_tl",
                                 harness.kind_module(root, "serve_closed_tl").CONTROLS)
    for control in ("no_coords", "fp8"):
        rows = readings.readings("tiny_tl.serve", [7], control, 0.5, device="cpu", root=root)
        assert rows[0]["correct"] is False, (control, rows[0]["numbers"])


def test_traced_tl_run_reports(root, capsys, tiny_tl_variant):
    rc, line = tiny.run(root, "tiny_tl.serve", trace=1, capsys=capsys)
    assert rc == 0 and line["correct"] is True
