"""The JAX package's public API tail, ported: each name against the JAX one
on the same numpy inputs.

* ``RunningConfusionMatrix`` equal to JAX exactly; ``RunningAUC`` and
  ``RunningRegressionMetrics`` within 1e-6 relative (float64 sums in
  another order); ``ConfusionMatrix.merge`` exactly; the ``empty``
  constructors;
* ``export_torch_checkpoint``: the same weights exported by both packages
  give the same keys, shapes and values, exactly, as ``.ckpt`` and
  ``.npz``; the port's file loads back through ``seg_state_dict_from_torch``
  with ``strict=True``;
* ``BestCheckpointer.restore``, ``get_carbon_info``,
  ``find_connected_tiles`` (with its mutation of ``remaining``),
  ``GeoTiffReader.profile`` / ``open_geotiff`` / ``read_geotiff``, the
  settings classes and their environment names, ``PrithviViT.num_patches``,
  the token-major ``flash_attention`` (the JAX kernel in interpret mode;
  forward atol 2e-5, rtol 1e-4 and gradients 2e-4, as
  ``tests/test_torch_attention.py``), ``supports_fused_dropout``,
  ``enable_compilation_cache``, and the packages' re-exports,
  ``__version__`` and ``__all__``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instageo_tpu
import instageo_tpu.models as jax_models
import instageo_tpu_torch
import instageo_tpu_torch.models as port_models
from instageo_tpu.data import data_splitter as jax_splitter
from instageo_tpu.data import geotiff as jax_geotiff
from instageo_tpu.data import settings as jax_settings
from instageo_tpu.models.checkpoint import export_torch_checkpoint as jax_export
from instageo_tpu.models.prithvi import PrithviViT as JaxPrithviViT
from instageo_tpu.models.registry import get_arch as jax_get_arch
from instageo_tpu.models.seg import create_prithvi_seg as jax_create_prithvi_seg
from instageo_tpu.ops.attention import flash_attention as jax_flash_attention
from instageo_tpu.ops.dropout import supports_fused_dropout as jax_supports_fused_dropout
from instageo_tpu.train import metrics as jm
from instageo_tpu.train.checkpointing import BestCheckpointer as JaxBestCheckpointer
from instageo_tpu.train.trainer import EpochMetrics as JaxEpochMetrics
from instageo_tpu.utils import telemetry as jax_telemetry
from instageo_tpu.utils.compile_cache import enable_compilation_cache as jax_enable_cache
from instageo_tpu_torch.data import data_splitter
from instageo_tpu_torch.data import geotiff
from instageo_tpu_torch.data import settings
from instageo_tpu_torch.models.checkpoint import (
    export_torch_checkpoint,
    load_torch_file,
    seg_state_dict_from_jax,
    seg_state_dict_from_torch,
)
from instageo_tpu_torch.models.prithvi import PrithviViT
from instageo_tpu_torch.models.registry import get_arch
from instageo_tpu_torch.models.seg import create_prithvi_seg
from instageo_tpu_torch.ops import attention as tattn
from instageo_tpu_torch.ops.dropout import supports_fused_dropout
from instageo_tpu_torch.train import metrics as tm
from instageo_tpu_torch.train.checkpointing import BestCheckpointer, model_variables
from instageo_tpu_torch.train.trainer import EpochMetrics
from instageo_tpu_torch.utils import compile_cache, telemetry
from tests.torch_parity import random_seg_variables

torch.set_num_threads(1)

METRIC_RTOL = 1e-6
ATOL, RTOL = 2e-5, 1e-4
GRAD_TOL = 2e-4


def _close(a, b, rtol=METRIC_RTOL):
    """Metric dicts equal key for key: numbers within ``rtol``, nan as nan."""
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(y, list):
            np.testing.assert_allclose(np.asarray(x, float), np.asarray(y, float), rtol=rtol,
                                       atol=0, equal_nan=True, err_msg=k)
        elif y is None or isinstance(y, bool):
            assert x == y, k
        else:
            np.testing.assert_allclose(float(x), float(y), rtol=rtol, atol=0, equal_nan=True,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# train/metrics.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ignore_index", [None, 0])
def test_running_confusion_matrix_equals_jax(ignore_index):
    rng = np.random.default_rng(1)
    ours, ref = tm.RunningConfusionMatrix(4, ignore_index), jm.RunningConfusionMatrix(
        4, ignore_index)
    for n in (1000, 37, 512):
        y, p = rng.integers(0, 4, n), rng.integers(0, 4, n)
        ours.update(torch.from_numpy(y) if n == 37 else y, p)
        ref.update(y, p)
    assert ours.compute() == ref.compute()
    ours.reset()
    ref.reset()
    y = rng.integers(0, 4, (3, 5))
    ours.update(y, y)
    ref.update(y, y)
    assert ours.compute(include_per_class=False) == ref.compute(include_per_class=False)
    with pytest.raises(ValueError):
        ours.update(np.zeros(3, int), np.zeros(4, int))


@pytest.mark.parametrize("classes,one_d,span", [(3, False, (0.0, 1.0)),
                                                 (2, True, (0.0, 1.0)),
                                                 (2, False, (-2.0, 3.0))])
def test_running_auc_equals_jax(classes, one_d, span):
    rng = np.random.default_rng(classes)
    ours = tm.RunningAUC(classes, n_bins=256, min_score=span[0], max_score=span[1])
    ref = jm.RunningAUC(classes, n_bins=256, min_score=span[0], max_score=span[1])
    for n in (4000, 333):
        y = rng.integers(0, classes, n)
        if one_d:
            s = rng.uniform(span[0] - 0.5, span[1] + 0.5, n)
        else:
            s = rng.uniform(span[0] - 0.5, span[1] + 0.5, (n, classes))
        ours.update(y, s)
        ref.update(y, s)
    _close(ours.score(), ref.score())
    if not one_d and classes == 3:
        with pytest.raises(ValueError):
            ours.update(np.zeros(3, int), np.zeros(3))


@pytest.mark.parametrize("include_ee", [False, True])
def test_running_regression_metrics_equal_jax(include_ee):
    rng = np.random.default_rng(5)
    ours = tm.RunningRegressionMetrics(ee_bias=0.1, ee_coef=0.2, include_ee=include_ee)
    ref = jm.RunningRegressionMetrics(ee_bias=0.1, ee_coef=0.2, include_ee=include_ee)
    for n in (2048, 99):
        x = rng.normal(40.0, 3.0, n)  # mean >> std: R² and Pearson cancel
        y = x + rng.normal(0.0, 0.5, n)
        ours.update(x, torch.from_numpy(y))
        ref.update(x, y)
    _close(ours.compute(), ref.compute())
    ours.reset()
    ref.reset()
    _close(ours.compute(), ref.compute())


def test_confusion_matrix_merge_and_empty_equal_jax():
    rng = np.random.default_rng(9)
    parts = [(rng.integers(-1, 5, 700), rng.integers(0, 5, 700)) for _ in range(2)]
    ours = [tm.ConfusionMatrix.empty(5) for _ in parts]
    refs = [jm.ConfusionMatrix.empty(5) for _ in parts]
    for i, (y, p) in enumerate(parts):
        ours[i].update(torch.from_numpy(y), torch.from_numpy(p), ignore_index=-1)
        refs[i] = refs[i].update(jnp.asarray(y), jnp.asarray(p), ignore_index=-1)
    assert ours[0].merge(ours[1]).compute() == refs[0].merge(refs[1]).compute()
    assert (tuple(tm.AucHistogram.empty(3, 64).pos_hist.shape)
            == tuple(jm.AucHistogram.empty(3, 64).pos_hist.shape))
    _close(tm.RegressionStats.empty().compute(), jm.RegressionStats.empty().compute())
    ep, jep = EpochMetrics.empty(1, with_auc=True), JaxEpochMetrics.empty(1)
    assert tuple(ep.cm.matrix.shape) == tuple(jep.cm.matrix.shape) == (2, 2)
    assert tuple(ep.auc.pos_hist.shape) == tuple(jep.auc.pos_hist.shape)


# ---------------------------------------------------------------------------
# models/checkpoint.py, train/checkpointing.py
# ---------------------------------------------------------------------------

KW = dict(depth=2, image_size=32, num_bands=6, num_classes=3)


@pytest.fixture(scope="module")
def seg_weights():
    """(JAX arch, numpy variables, the port's model holding them)."""
    model = jax_create_prithvi_seg("prithvi_eo_tiny", temporal_step=1, **KW)
    variables = random_seg_variables(model, 1, 32, seed=11)
    jarch = jax_get_arch("prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32, depth=2)
    arch = get_arch("prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=32, depth=2)
    port = create_prithvi_seg("prithvi_eo_tiny", temporal_step=1, device="cpu", **KW)
    port.load_state_dict(seg_state_dict_from_jax(variables, arch), strict=True)
    return jarch, variables, port


@pytest.mark.parametrize("suffix", [".ckpt", ".npz"])
def test_export_torch_checkpoint_equals_jax(seg_weights, tmp_path, suffix):
    jarch, variables, port = seg_weights
    ref = load_torch_file(jax_export(variables, jarch, str(tmp_path / f"jax{suffix}")))
    for source in (port, port.state_dict()):
        ours = load_torch_file(export_torch_checkpoint(source, str(tmp_path / f"port{suffix}")))
        assert sorted(ours) == sorted(ref)
        for k in ref:
            assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
            assert torch.equal(ours[k], ref[k]), k
    if suffix == ".ckpt":
        raw = torch.load(str(tmp_path / "port.ckpt"), weights_only=True)
        assert list(raw) == ["state_dict"]
    fresh = create_prithvi_seg("prithvi_eo_tiny", temporal_step=1, device="cpu", **KW)
    fresh.load_state_dict(seg_state_dict_from_torch(load_torch_file(
        str(tmp_path / f"port{suffix}"))), strict=True)
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_best_checkpointer_restore_equals_jax(seg_weights, tmp_path):
    _, variables, port = seg_weights
    jax_ckpt = JaxBestCheckpointer(str(tmp_path / "jax"))
    jax_ckpt.save(types.SimpleNamespace(step=np.int32(7), params=variables["params"],
                                        batch_stats=variables["batch_stats"],
                                        opt_state=None))
    restored = jax.tree.map(np.asarray, jax_ckpt.restore())
    ckpt = BestCheckpointer(str(tmp_path / "port"))
    ckpt.save({**model_variables(port), "step": 7}, metrics={"val_IoU": 0.5})
    ours = ckpt.restore()
    assert int(restored["step"]) == int(ours["step"]) == 7
    # The same tree, leaf for leaf and bit for bit.
    assert jax.tree.structure(ours) == jax.tree.structure(restored)
    jax.tree.map(np.testing.assert_array_equal, ours, restored)


def test_get_carbon_info_returns_the_trackers_results():
    ours, ref = telemetry.EmissionsTracker(), jax_telemetry.EmissionsTracker()
    for t in (ours, ref):
        t.start()
        t.stop()
    info, ref_info = telemetry.get_carbon_info(ours), jax_telemetry.get_carbon_info(ref)
    assert info.keys() == ref_info.keys()
    assert info == ours.results and info is not ours.results


# ---------------------------------------------------------------------------
# data/
# ---------------------------------------------------------------------------

TILES = ["33TUN", "33TUM", "33TVN", "28PCA", "28PDA", "37MBN", "37MCN", "37MBM"]


@pytest.mark.parametrize("tile,threshold", [("33TUN", 400.0), ("28PCA", 150.0),
                                            ("37MBN", 5.0), ("33TVN", 5000.0)])
def test_find_connected_tiles_equals_jax(tile, threshold):
    ours, ref = set(TILES), set(TILES)
    got = data_splitter.find_connected_tiles(tile, ours, threshold)
    want = jax_splitter.find_connected_tiles(tile, ref, threshold)
    assert got == want and ours == ref
    assert tile in got and not got & ours


def test_geotiff_profile_open_and_read_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 5000, (3, 20, 24)).astype(np.uint16)
    path = str(tmp_path / "t.tif")
    geotiff.write_geotiff(path, arr, transform=geotiff.Affine.from_origin(500000, 4100000, 30, 30),
                          crs=32633, nodata=0)
    with geotiff.open_geotiff(path) as r, jax_geotiff.open_geotiff(path) as jr:
        p, jp = r.profile, jr.profile
        assert p.keys() == jp.keys()
        assert p.pop("transform").to_gdal() == jp.pop("transform").to_gdal()
        assert p == jp
    for idx in (None, 2, [3, 1]):
        np.testing.assert_array_equal(geotiff.read_geotiff(path, idx),
                                      jax_geotiff.read_geotiff(path, idx))


@pytest.mark.parametrize("name", ["BLOCK_SIZES", "HLS_API", "S2_API", "S1_API",
                                  "NO_DATA_VALUES", "BANDS_SETTINGS"])
def test_settings_values_equal_jax(name):
    assert dataclasses.asdict(getattr(settings, name)) == getattr(jax_settings, name).model_dump()


def test_settings_classes_equal_jax():
    for cls in ("BlockSizes", "HLSAPISettings", "S2APISettings", "S1APISettings"):
        assert (dataclasses.asdict(getattr(settings, cls)())
                == getattr(jax_settings, cls)().model_dump()), cls
        assert issubclass(getattr(settings, cls), settings.APISettings) == cls.endswith("APISettings")
    gdal = jax_settings.GDALOptions().model_dump()
    assert {k: getattr(settings.GDAL_OPTIONS, k) for k in gdal} == gdal
    assert settings.MPC_STAC_API_URL == jax_settings.MPC_STAC_API_URL


def test_settings_environment_names_equal_jax():
    """The same environment variables set the same values, read at import
    in a fresh interpreter."""
    code = ("import json, dataclasses; "
            "from instageo_tpu.data import settings as j; "
            "from instageo_tpu_torch.data import settings as p; "
            "print(json.dumps([j.DATA_PIPELINE_SETTINGS.model_dump(), "
            "dataclasses.asdict(p.DATA_PIPELINE_SETTINGS)]))")
    env = {**os.environ, "DATAPIPELINESETTINGS_BATCH_SIZE": "10",
           "INSTAGEO_SEARCH_RATELIMIT": "7",
           "DATAPIPELINESETTINGS_COG_DOWNLOAD_RATELIMIT": "99"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=env, check=True).stdout
    ref, ours = json.loads(out.strip().splitlines()[-1])
    assert ours == ref == {"BATCH_SIZE": 10, "METADATA_SEARCH_RATELIMIT": 7,
                           "COG_DOWNLOAD_RATELIMIT": 99}


# ---------------------------------------------------------------------------
# models/, ops/, utils/, the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("img,patch,frames", [(32, (1, 16, 16), 1), (64, (1, 16, 16), 3),
                                              (28, (1, 14, 14), 4), (224, (2, 16, 16), 4)])
def test_num_patches_equals_jax(img, patch, frames):
    ours = PrithviViT(img_size=img, patch_size=patch, num_frames=frames, in_chans=2,
                      embed_dim=16, depth=1, num_heads=1)
    ref = JaxPrithviViT(img_size=img, patch_size=patch, num_frames=frames)
    assert ours.num_patches == ref.num_patches == int(np.prod(ours.grid_size))


def test_token_major_flash_attention_equals_jax():
    """(B, L, H, Dh) in and out, forward and gradients, against the JAX
    entry's Pallas kernels in interpret mode."""
    rng = np.random.default_rng(4)
    q, k, v, do = (rng.standard_normal((2, 37, 4, 64)).astype(np.float32) for _ in range(4))
    out_ref, vjp = jax.vjp(lambda *a: jax_flash_attention(*a, interpret=True),
                           *(jnp.asarray(x) for x in (q, k, v)))
    refs = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    fwd0, bwd0 = tattn.launches.count, tattn.bwd_launches.count
    out = tattn.flash_attention(*leaves)
    out.backward(torch.from_numpy(do))
    assert (tattn.launches.count, tattn.bwd_launches.count) == (fwd0, bwd0)
    assert out.shape == (2, 37, 4, 64)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), atol=ATOL, rtol=RTOL)
    for name, t, ref in zip("qkv", leaves, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")


def test_supports_fused_dropout_on_the_cpu_is_false_as_in_jax():
    x = np.zeros((8, 512), np.float32)
    assert supports_fused_dropout(torch.from_numpy(x)) is False
    assert jax_supports_fused_dropout(jnp.asarray(x)) is False


def test_enable_compilation_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("INSTAGEO_COMPILE_CACHE", "0")
    # Recorded by monkeypatch, so the variable the call sets is undone after.
    monkeypatch.setenv("INSTAGEO_COMPILE_CACHE_DIR", str(tmp_path / "before"))
    assert compile_cache.enable_compilation_cache(str(tmp_path)) is False
    assert jax_enable_cache(str(tmp_path)) is False
    monkeypatch.delenv("INSTAGEO_COMPILE_CACHE")
    monkeypatch.delenv("INSTAGEO_COMPILE_CACHE_DIR")
    root = tmp_path / "builds"
    assert compile_cache.enable_compilation_cache(str(root)) is True
    assert compile_cache.build_root() == root and root.is_dir()


def test_package_exports_equal_jax():
    assert instageo_tpu_torch.__version__ == instageo_tpu.__version__
    assert instageo_tpu_torch.__all__ == instageo_tpu.__all__
    assert port_models.__all__ == jax_models.__all__
    assert sorted(port_models.PRITHVI_ARCHS) == sorted(jax_models.PRITHVI_ARCHS)
    assert port_models.HLS_BANDS == jax_models.HLS_BANDS
    assert port_models.get_arch("prithvi_eo_v2_300").embed_dim == \
        jax_models.get_arch("prithvi_eo_v2_300").embed_dim
