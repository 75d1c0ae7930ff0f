"""The plain reference agrees with instageo_tpu_torch at prithvi_eo_tiny
sizes on the CPU: the program in float32 equals it to rounding, serving
and training alike (dropout masks, BatchNorm statistics, the loss and
AdamW included)."""

import json
import time

import pytest
import torch

from h100bench import harness
from h100bench.common import Context, make_weights, program_config, reference_module
from h100bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


def _ctx(root, cell, **kw):
    files = harness.cell_files(root, harness.find_cell(harness.load_benchmark(root), cell))
    return Context(cell=cell, config=files["config"], traffic=files["traffic"], limits={},
                   seed=77, seconds=0, trace=False, device=torch.device("cpu"),
                   t_process=time.perf_counter(), **kw), files


def test_serving_logits_equal_in_float32(root):
    from instageo_tpu_torch.ops.preprocess import preprocess_chips
    from instageo_tpu_torch.serve.server import ModelServer

    ctx, files = _ctx(root, "tiny.serve")
    cfg = files["config"]
    ref, m = reference_module(cfg), cfg["model"]
    w = make_weights(ref.param_spec(m), 5, torch.device("cpu"))
    server = ModelServer(program_config(cfg, {"tpu.precision": "f32"}), device="cpu")
    server.model.load_state_dict(w, strict=True)
    raw = torch.randint(0, 5000, (3, cfg["raw_chips"]["bands"], 40, 40), dtype=torch.int32)
    pp = server.preprocess
    x = preprocess_chips(raw, torch.tensor(pp["mean"]), torch.tensor(pp["std"]),
                         temporal_size=pp["temporal_size"], bands=torch.tensor(pp["bands"]),
                         constant_multiplier=pp["constant_multiplier"], img_size=pp["img_size"])
    with torch.no_grad():
        got = server.model(x)
    dl = cfg["program"]["dataloader"]
    want = ref.serve_logits(w, raw, m, dict(
        bands=dl["bands"], mean=dl["mean"], std=dl["std"], temporal_size=dl["temporal_dim"],
        constant_multiplier=dl["constant_multiplier"], img_size=dl["img_size"]))
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6 * want.abs().max().item())


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_training_steps_equal_in_float32(tmp_path, grad_accum):
    root = tiny.make(tmp_path, grad_accum=grad_accum)
    ctx, files = _ctx(root, "tiny.train", overrides={"tpu.precision": "f32"})
    out = harness.kind_module(root, "train_epoch").run(ctx)
    n = out["numbers"]
    assert n["_loss1"] < 1e-5 and n["loss"] < 1e-4   # round-off grows over the 1 + 2k steps
    assert n["grad_leaf"] < 1e-5
    assert n["change_leaf"] < 1e-2


def test_dropout_mask_is_the_programs_stream():
    from instageo_tpu_torch.ops.dropout import fused_dropout_seeded_plain

    cfg = json.loads((tiny.BENCH / "configs" / "v1_100m_crop.json").read_text())
    ref = reference_module(cfg)
    x = torch.ones(2, 3, 37, 41)
    for seed in (0, 12345, 2**63 - 5):
        _, mask = fused_dropout_seeded_plain(x, 0.1, seed)
        assert torch.equal(ref.keep_mask(x.shape, 0.1, seed, "cpu"), mask)


def test_step_seeds_are_the_programs_draws():
    from instageo_tpu_torch.models.seg import draw_seed

    cfg = json.loads((tiny.BENCH / "configs" / "v1_100m_crop.json").read_text())
    ref = reference_module(cfg)
    g = torch.Generator().manual_seed(9)
    want = []
    for _ in range(2):
        step = torch.Generator().manual_seed(draw_seed(g))
        want.append([draw_seed(step) for _ in range(5)])
    assert ref.step_seeds(torch.Generator().manual_seed(9), 2, 5) == want
