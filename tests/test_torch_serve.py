"""Parity of the port's serving path with the JAX package on the same weights.

Predictions are int8 argmax classes; they must be equal wherever the JAX
logits' top-2 gap is at least 1e-3 (below that, float32 summation order may
flip the argmax). Probabilities: atol 1e-5 (float32 softmax of logits that
agree to ~1e-5).
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from instageo_tpu.data.geotiff import GeoTiffReader as JaxGeoTiffReader
from instageo_tpu.models.seg import create_prithvi_seg as jax_create_prithvi_seg
from instageo_tpu.ops.preprocess import make_fused_predict_fn as jax_fused_predict
from instageo_tpu.ops.preprocess import preprocess_chips as jax_preprocess_chips
from instageo_tpu.serve.infer import make_predict_fn as jax_make_predict_fn
from instageo_tpu_torch.configs.config import load_config
from instageo_tpu_torch.data.geotiff import Affine, write_geotiff
from instageo_tpu_torch.models.checkpoint import seg_state_dict_from_jax
from instageo_tpu_torch.models.registry import get_arch
from instageo_tpu_torch.models.seg import create_prithvi_seg
from instageo_tpu_torch.ops.preprocess import make_fused_predict_fn
from instageo_tpu_torch.serve.batching import DynamicBatcher
from instageo_tpu_torch.serve.infer import make_predict_fn
from instageo_tpu_torch.serve.server import ModelServer
from instageo_tpu_torch.train.checkpointing import BestCheckpointer
from tests.torch_parity import random_seg_variables

torch.set_num_threads(1)

GAP = 1e-3
KW = dict(depth=2, image_size=32, num_bands=6, num_classes=3)
# Raw chips: 8 bands of 36x36, bands 1-5 and 7 selected, centre-cropped to 32.
PRE = dict(temporal_size=1, bands=(1, 2, 3, 4, 5, 7), constant_multiplier=0.5,
           img_size=32)
MEAN = [900.0, 1100.0, 1300.0, 2500.0, 2000.0, 1500.0]
STD = [400.0, 500.0, 600.0, 900.0, 800.0, 700.0]


@pytest.fixture(scope="module")
def models():
    """(JAX model, numpy variables, port model on the CPU), same weights."""
    jax_model = jax_create_prithvi_seg("prithvi_eo_tiny", temporal_step=1, **KW)
    variables = random_seg_variables(jax_model, 1, 32, seed=11)
    port = create_prithvi_seg("prithvi_eo_tiny", temporal_step=1, device="cpu", **KW)
    arch = get_arch("prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32, depth=2)
    port.load_state_dict(seg_state_dict_from_jax(variables, arch), strict=True)
    return jax_model, variables, port


def _raw_chips(n, seed):
    # Values above 32767 check that uint16 is not read as signed.
    return np.random.default_rng(seed).integers(0, 65535, (n, 8, 36, 36)).astype(np.uint16)


def _assert_argmax_agrees(pred, ref, logits_ref):
    top2 = np.sort(np.asarray(logits_ref), axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) >= GAP
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(pred)[decided], np.asarray(ref)[decided])


def test_fused_raw_predict_matches_jax(models):
    jax_model, variables, port = models
    raw = _raw_chips(3, seed=0)
    ref = jax_fused_predict(jax_model, variables, MEAN, STD, **PRE)(jnp.asarray(raw))
    x = jax_preprocess_chips(jnp.asarray(raw), jnp.asarray(MEAN), jnp.asarray(STD),
                             temporal_size=1, bands=PRE["bands"],
                             constant_multiplier=0.5, img_size=32)
    logits_ref = jax_model.apply(variables, x, channels_last=True)
    pred = make_fused_predict_fn(port, MEAN, STD, **PRE)(raw)
    assert pred.shape == (3, 32, 32) and pred.dtype == torch.int8
    _assert_argmax_agrees(pred.numpy(), ref, logits_ref)


def test_predict_fn_matches_jax(models):
    jax_model, variables, port = models
    x = np.random.default_rng(1).standard_normal((2, 6, 1, 32, 32)).astype(np.float32)
    logits_ref = jax_model.apply(variables, jnp.asarray(x), channels_last=True)
    ref = jax_make_predict_fn(jax_model, variables)(jnp.asarray(x))
    _assert_argmax_agrees(make_predict_fn(port)(x).numpy(), ref, logits_ref)
    probs_ref = jax_make_predict_fn(jax_model, variables, probabilities=True)(jnp.asarray(x))
    probs = make_predict_fn(port, probabilities=True)(x)
    assert probs.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(probs.numpy(), np.asarray(probs_ref), atol=1e-5, rtol=0)


def test_dynamic_batcher_concurrent_submits():
    batcher = DynamicBatcher(lambda x: x.reshape(len(x), -1).sum(axis=1),
                             max_batch=8, max_wait_ms=2.0)
    results = {}

    def client(i):
        for j in range(5):
            x = np.full((2, 3), float(10 * i + j), np.float32)
            results[(i, j)] = batcher.submit(x).result(timeout=10)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
        assert not any(t.is_alive() for t in threads)
    finally:
        batcher.close()
    assert results == {(i, j): 6.0 * (10 * i + j) for i in range(8) for j in range(5)}
    assert batcher.requests_served == 40 and batcher.batches_run <= 40


def _server_cfg(port, tmp_path):
    """A config whose checkpoint holds ``port``'s weights and whose
    dataloader section is ``PRE`` (the tiny model, float32, on the CPU)."""
    ckpt = BestCheckpointer(str(tmp_path / "run")).save({"model": port.state_dict()})
    return load_config("config", overrides={
        "device": "cpu", "checkpoint_path": ckpt, "model.model_name": "prithvi_eo_tiny",
        "model.depth": KW["depth"], "model.num_classes": KW["num_classes"],
        "model.load_pretrained_weights": False, "dataloader.img_size": PRE["img_size"],
        "dataloader.bands": list(PRE["bands"]), "dataloader.mean": MEAN,
        "dataloader.std": STD, "dataloader.temporal_dim": PRE["temporal_size"],
        "dataloader.constant_multiplier": PRE["constant_multiplier"],
        "tpu.precision": "f32"})


def test_server_chip_inference_roundtrip(models, tmp_path):
    """3 chips through ModelServer.chip_inference_from_paths (batch 2, so the
    tail batch is padded), read back with the JAX package's reader; the
    server is built from a config whose checkpoint holds the port model's
    weights."""
    _, _, port = models
    raw = _raw_chips(3, seed=2)
    transform = Affine.from_origin(500000.0, 4200000.0, 30.0, 30.0)
    paths = []
    for i in range(3):
        path = str(tmp_path / f"tile_{i}_chip.tif")
        write_geotiff(path, raw[i], transform=transform, crs=32633)
        paths.append(path)
    server = ModelServer(_server_cfg(port, tmp_path))
    try:
        out = server.chip_inference_from_paths(paths, str(tmp_path / "pred"),
                                               batch_size=2)
        assert out["num_chips"] == 3
        expected = make_fused_predict_fn(port, MEAN, STD, **PRE)(raw).numpy()
        for i in range(3):
            with JaxGeoTiffReader(str(tmp_path / "pred" / f"tile_{i}_prediction.tif")) as r:
                pred = r.read()[0]
                assert r.crs == 32633
                # Predictions cover the centre crop: 2 px in from the chip's corner.
                assert (r.transform.c, r.transform.f) == (500060.0, 4199940.0)
            assert pred.dtype == np.int8
            np.testing.assert_array_equal(pred, expected[i])
        chip = np.random.default_rng(3).standard_normal((6, 1, 32, 32)).astype(np.float32)
        batcher = server.online_batcher(max_batch=4)
        assert batcher.submit(chip).result(timeout=30).shape == (32, 32)
        health = server.health_check()
        assert health["requests_served"] == 1
        assert health["device"]["platform"] == "cpu"
    finally:
        server.close()


def test_port_imports_nothing_of_jax():
    """Importing every module and package of the port, the serving layer, the
    chip creators and the web platform included, pulls in neither JAX, the
    JAX package, nor the libraries the port does without (PyYAML, pandas,
    OpenCV, pydantic, requests, absl, pyarrow, scikit-learn, PIL, aiohttp,
    cryptography)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "instageo_tpu_torch")
    modules = sorted(
        os.path.relpath(d if f == "__init__.py" else os.path.join(d, f[:-3]), root)
        .replace(os.sep, ".")
        for d, _, files in os.walk(pkg) for f in files if f.endswith(".py"))
    assert "instageo_tpu_torch.train.run" in modules and len(modules) >= 30
    for new in ("serve.export", "serve.pipeline", "serve.registry",
                "configs.config_dataclasses", "serve.granule", "ops.chip_ops",
                "data.stac", "data.remote_io", "data.settings", "data.pipeline",
                "data.sources.hls", "data.sources.s1", "data.sources.s2",
                "utils.ratelimit", "data.crs", "data.geo_utils", "data.table",
                "data.flags", "data.downloads", "data.chip_creator", "data.parquet",
                "data.raster_chip_creator", "webapp.settings", "webapp.db", "webapp.queue",
                "webapp.tasks", "webapp.data_processor", "webapp.cog", "webapp.png",
                "webapp.tiler", "webapp.auth", "webapp.docs", "webapp.web", "webapp.main",
                "webapp.selftest_goldens", "apps.viz", "apps.app", "parallel.mesh",
                "parallel.fsdp", "parallel.tp", "parallel.pp", "parallel.multihost"):
        assert f"instageo_tpu_torch.{new}" in modules
    assert "instageo_tpu_torch.native" in modules  # the decoder's binding is a package
    code = ("import sys, importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'flax', 'instageo_tpu', 'yaml', 'pandas', 'cv2', 'pydantic',\n"
            "        'requests', 'absl', 'pyarrow', 'sklearn', 'PIL', 'aiohttp',\n"
            "        'cryptography')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
