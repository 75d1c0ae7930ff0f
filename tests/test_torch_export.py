"""The port's serving artifact (``serve/export.py``) against the JAX
package's (``tests/serve_tests/test_export.py``), on the CPU.

The tiny model (depth 2, 32 px, 6 bands, 3 classes) gets the JAX model's
seeded numpy weights through the bridge. On the CPU the exported program
runs the same plain attention as the live model, so its outputs equal the
live predict exactly; against the JAX artifact, class ids agree wherever the
JAX logits' top-2 gap is at least 1e-3 (``tests/test_torch_serve.py``) and
probabilities within 1e-5.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instageo_tpu.models.seg import create_prithvi_seg as jax_create_prithvi_seg
from instageo_tpu.serve.export import export_predict as jax_export_predict
from instageo_tpu.serve.export import load_predict as jax_load_predict
from instageo_tpu_torch.configs.config import load_config
from instageo_tpu_torch.models.checkpoint import seg_state_dict_from_jax
from instageo_tpu_torch.models.registry import get_arch
from instageo_tpu_torch.models.seg import create_prithvi_seg
from instageo_tpu_torch.serve.export import export_predict, load_predict
from instageo_tpu_torch.serve.infer import make_predict_fn
from instageo_tpu_torch.serve.server import ModelServer
from instageo_tpu_torch.train.checkpointing import BestCheckpointer, model_variables
from tests.torch_parity import random_seg_variables

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAP = 1e-3
PROBS_ATOL = 1e-5
KW = dict(depth=2, image_size=32, num_bands=6, num_classes=3)
# What the plain attention computes, op by op (ops/attention.py); none may
# appear in a class-id artifact, whose attention is the custom op.
PLAIN_ATTENTION_OPS = {"amax", "exp", "log", "matmul", "bmm", "softmax", "_softmax"}


@pytest.fixture(scope="module")
def models():
    """(JAX model, numpy variables, port model on the CPU), same weights."""
    jax_model = jax_create_prithvi_seg("prithvi_eo_tiny", **KW)
    variables = random_seg_variables(jax_model, 1, 32, seed=12)
    port = create_prithvi_seg("prithvi_eo_tiny", device="cpu", **KW)
    arch = get_arch("prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32, depth=2)
    port.load_state_dict(seg_state_dict_from_jax(variables, arch), strict=True)
    return jax_model, variables, port


def _x(b, seed):
    return np.random.default_rng(seed).normal(size=(b, 6, 1, 32, 32)).astype(np.float32)


def _call_targets(path):
    program = torch.export.load(path)
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


def test_export_roundtrip_matches_live_predict(models, tmp_path):
    jax_model, variables, port = models
    path = str(tmp_path / "predict.pt2")
    export_predict(port, path, num_bands=6, img_size=32)
    predict, meta = load_predict(path)
    assert meta["input_shape"] == [None, 6, 1, 32, 32]
    assert meta["output"] == "class_ids" and meta["device"] == "cpu"
    assert meta["custom_ops"] == ["instageo_tpu_torch::flash_attn_fwd"]
    assert meta["artifact_version"] == 1 and meta["torch_version"] == torch.__version__

    ref_path = str(tmp_path / "predict.stablehlo")
    jax_export_predict(jax_model, variables, ref_path, num_bands=6, img_size=32,
                       platforms=("cpu",))
    ref_predict, ref_meta = jax_load_predict(ref_path)
    assert ref_meta["input_shape"] == meta["input_shape"] and ref_meta["output"] == "class_ids"

    live = make_predict_fn(port)
    # Symbolic batch: the one artifact serves several batch sizes.
    for b in (1, 4, 7):
        x = _x(b, b)
        got = predict(port.state_dict(), x)
        assert got.shape == (b, 32, 32) and got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), live(x).numpy())
        logits = np.asarray(jax_model.apply(variables, jnp.asarray(x), channels_last=True))
        top2 = np.sort(logits, axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) >= GAP
        assert decided.mean() > 0.9
        np.testing.assert_array_equal(got.numpy()[decided],
                                      ref_predict(variables, x)[decided])


def test_graph_holds_the_attention_op_and_no_plain_attention(models, tmp_path):
    _, _, port = models
    path = export_predict(port, str(tmp_path / "g.pt2"), num_bands=6, img_size=32)
    targets = _call_targets(path)
    assert targets.count("instageo_tpu_torch.flash_attn_fwd.default") == KW["depth"]
    plain = [t for t in targets if t.startswith("aten.")
             and t.split(".")[1] in PLAIN_ATTENTION_OPS]
    assert not plain, plain


def test_export_probabilities_and_pinned_batch(models, tmp_path):
    jax_model, variables, port = models
    path = str(tmp_path / "probs.pt2")
    export_predict(port, path, num_bands=6, img_size=32, probabilities=True, batch_size=2)
    predict, meta = load_predict(path)
    assert meta["input_shape"][0] == 2 and meta["output"] == "probabilities"
    x = _x(2, 5)
    probs = predict(port.state_dict(), x)
    assert probs.shape == (2, 32, 32, 3) and probs.dtype == torch.float32
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-5)
    ref = jax_export_predict(jax_model, variables, str(tmp_path / "probs.stablehlo"),
                             num_bands=6, img_size=32, probabilities=True, batch_size=2,
                             platforms=("cpu",))
    np.testing.assert_allclose(probs.numpy(), jax_load_predict(ref)[0](variables, x),
                               rtol=0, atol=PROBS_ATOL)
    # A pinned-batch artifact rejects other batch sizes loudly.
    with pytest.raises(Exception):
        predict(port.state_dict(), _x(3, 6))


def test_export_regression_output(tmp_path):
    model = create_prithvi_seg("prithvi_eo_tiny", depth=1, image_size=32, num_classes=1,
                               device="cpu")
    path = export_predict(model, str(tmp_path / "reg.pt2"), num_bands=6, img_size=32,
                          is_reg_task=True)
    predict, meta = load_predict(path)
    x = _x(2, 7)
    out = predict(model.state_dict(), x)
    assert meta["output"] == "regression" and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(),
                                  make_predict_fn(model, is_reg_task=True)(x).numpy())


def test_model_server_export_artifact(models, tmp_path):
    _, _, port = models
    ckpt = BestCheckpointer(str(tmp_path / "run")).save(model_variables(port))
    cfg = load_config("config", overrides={
        "device": "cpu", "checkpoint_path": ckpt, "dataloader.img_size": 32,
        "dataloader.bands": [0, 1, 2, 3, 4, 5], "model.model_name": "prithvi_eo_tiny",
        "model.depth": 2, "model.num_classes": 3, "model.load_pretrained_weights": False,
        "tpu.precision": "f32"})
    server = ModelServer(cfg)
    path = server.export_artifact(str(tmp_path / "server.pt2"))
    predict, meta = load_predict(path)
    assert meta["input_shape"] == [None, 6, 1, 32, 32]
    x = _x(2, 8)
    np.testing.assert_array_equal(predict(server.model.state_dict(), x).numpy(),
                                  make_predict_fn(port)(x).numpy())


def test_export_artifact_is_code_free_and_small(models, tmp_path):
    """The artifact carries the program, not the weights: it stays under 4
    bytes per parameter, the SAME artifact serves other weights, and it
    reloads and runs in an interpreter that never imports the port's
    models."""
    _, _, port = models
    path = export_predict(port, str(tmp_path / "predict.pt2"), num_bands=6, img_size=32)
    n_params = sum(p.numel() for p in port.parameters())
    assert os.path.getsize(path) < 4 * n_params

    predict, _ = load_predict(path)
    other = {k: v + 0.01 if v.is_floating_point() else v for k, v in port.state_dict().items()}
    shifted = create_prithvi_seg("prithvi_eo_tiny", device="cpu", **KW)
    shifted.load_state_dict(other, strict=True)
    x = _x(2, 9)
    np.testing.assert_array_equal(predict(other, x).numpy(), make_predict_fn(shifted)(x).numpy())

    weights, inputs, expected = (str(tmp_path / n) for n in ("w.pt", "x.pt", "y.pt"))
    torch.save(port.state_dict(), weights)
    torch.save(torch.from_numpy(x), inputs)
    torch.save(make_predict_fn(port)(x), expected)
    code = ("import sys, torch\n"
            "from instageo_tpu_torch.serve.export import load_predict\n"
            "predict, meta = load_predict(sys.argv[1])\n"
            "state = torch.load(sys.argv[2], weights_only=True)\n"
            "got = predict(state, torch.load(sys.argv[3], weights_only=True))\n"
            "assert torch.equal(got, torch.load(sys.argv[4], weights_only=True))\n"
            "bad = [m for m in sys.modules if m.startswith('instageo_tpu_torch.models')\n"
            "       or m.split('.')[0] in ('jax', 'instageo_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code, path, weights, inputs, expected], cwd=ROOT,
                   check=True, timeout=300)


def test_artifact_of_another_device_type_raises(models, tmp_path):
    _, _, port = models
    path = export_predict(port, str(tmp_path / "p.pt2"), num_bands=6, img_size=32)
    with open(path + ".json") as f:
        meta = json.load(f)
    meta["device"] = "cuda"
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            load_predict(path)


def test_artifact_without_its_sidecar_raises(models, tmp_path):
    _, _, port = models
    path = export_predict(port, str(tmp_path / "p.pt2"), num_bands=6, img_size=32)
    os.remove(path + ".json")
    with pytest.raises(FileNotFoundError, match="sidecar"):
        load_predict(path)
