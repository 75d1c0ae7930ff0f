"""The port's web platform against the JAX package's.

World (``tests/torch_webapp_helpers.py``): one HLS granule of a 96 px tile
(the JAX webapp tests' world), its STAC item (both packages' search answers
with it), and a registry with one model, ``toy_model``: the tiny encoder at
depth 2, 2 classes, 32 px, float32, with seeded random weights in a
reference ``.ckpt`` that both packages read (no training). The port runs
with ``INSTAGEO_DEVICE=cpu`` (``settings.DEVICE``); both queues are drained
in process.

* the task lifecycle: the same requests against the JAX aiohttp app (its
  ``TestClient``) and against the port's server on a localhost socket give
  the same statuses and JSON bodies (task ids, times and job function paths
  aside); the chips, the manifest and the chips COG byte for byte, the
  prediction rasters equal on at least ``AGREEMENT`` of decided pixels
  (the port's top-2 logit gap at least ``DECIDED_GAP``, the serving tests'
  bound), the segmentation statistics within that share; tiles and previews
  decoded to the same RGBA (chips exactly, predictions on ``AGREEMENT`` of
  their pixels);
* ``write_cog`` byte for byte; the tiler in every mode (decoded RGBA,
  statistics, tilejson), its path checks, cache invalidation and concurrent
  renders; the PNG encoder;
* RS256: the port's verifier gives JAX's ``verify_jwt`` outcome on tokens
  signed here with ``cryptography``;
* the queue (claim, run, failure, timeout reap, a hung isolated job
  killed), the data processor's flags and manifest, the OpenAPI spec, the
  docs page and the route set, the selftest goldens and the static files;
* the device: with ``INSTAGEO_DEVICE=cuda`` and no card, stage 1 and stage
  2 each fail their task with an error that names CUDA; the server process
  imports no torch; ``python -m instageo_tpu_torch.webapp.main`` answers.
"""

import asyncio
import concurrent.futures
import io
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from instageo_tpu.configs.config import load_config as jax_load_config
from instageo_tpu.data import raster_chip_creator as jax_rcc
from instageo_tpu.data import stac as jax_stac
from instageo_tpu.data.geotiff import GeoTiffReader as JaxGeoTiffReader
from instageo_tpu.data.geotiff import write_cog as jax_write_cog
from instageo_tpu.data.geotiff import Affine as JaxAffine
from instageo_tpu.data.sources import hls as jax_hls
from instageo_tpu.models.checkpoint import export_torch_checkpoint
from instageo_tpu.models.registry import get_arch as jax_get_arch
from instageo_tpu.train import factory as jax_factory
from instageo_tpu.webapp import auth as jax_auth
from instageo_tpu.webapp import data_processor as jax_dp
from instageo_tpu.webapp import docs as jax_docs
from instageo_tpu.webapp import main as jax_main
from instageo_tpu.webapp import queue as jax_queue
from instageo_tpu.webapp import selftest_goldens as jax_goldens
from instageo_tpu.webapp import settings as jax_settings
from instageo_tpu.webapp import tiler as jax_tiler
from instageo_tpu_torch.configs.config import load_config
from instageo_tpu_torch.data import raster_chip_creator, stac
from instageo_tpu_torch.data.geotiff import Affine, GeoTiffReader, write_cog, write_geotiff
from instageo_tpu_torch.data.sources import hls
from instageo_tpu_torch.ops.preprocess import preprocess_chips, raw_to_device
from instageo_tpu_torch.serve.server import ModelServer
from instageo_tpu_torch.webapp import auth, db, docs, queue, selftest_goldens, settings, tiler, web
from instageo_tpu_torch.webapp.data_processor import DataProcessor
from instageo_tpu_torch.webapp.main import create_app
from instageo_tpu_torch.webapp.png import encode_png
from tests import torch_webapp_helpers as helpers
from tests.torch_parity import random_seg_variables

torch.set_num_threads(1)

DECIDED_GAP = 2e-3  # tests/test_torch_serving.py's decided pixels
AGREEMENT = 0.999
TIMES = {"created_at", "started_at", "finished_at", "updated_at", "expires_at", "enqueued_at"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(coro):
    return asyncio.get_event_loop_policy().new_event_loop().run_until_complete(coro)


def _rgba(png: bytes) -> np.ndarray:
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGBA"))


# ---------------------------------------------------------------------------
# World
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("webapp")
    item, bbox = helpers.granule_world(str(root))
    jcfg = jax_load_config("config", overrides=helpers.model_overrides())
    variables = random_seg_variables(jax_factory.build_model(jcfg), 1, helpers.CHIP, seed=21)
    ckpt = str(root / "model.ckpt")
    export_torch_checkpoint(variables, jax_get_arch(
        "prithvi_eo_tiny", in_chans=6, num_frames=1, img_size=helpers.CHIP, depth=2), ckpt)
    config_yaml = load_config("config", overrides=helpers.model_overrides()).to_yaml()
    registry, models = helpers.write_model(str(root), config_yaml, ckpt)
    return {"root": root, "item": item, "bbox": bbox, "registry": registry,
            "models": models, "ckpt": ckpt}


class _NoPause:
    @staticmethod
    def sleep(seconds):
        pass


@pytest.fixture
def env(world, tmp_path, monkeypatch):
    """Both packages wired to ``world``: registry, STAC search, settings
    (separate task and database paths), no rate limits."""
    monkeypatch.setenv("MODELS_REGISTRY_PATH", world["registry"])
    monkeypatch.setenv("MODELS_PATH", world["models"])
    monkeypatch.setattr(jax_stac, "time", _NoPause)
    monkeypatch.setattr(stac, "time", _NoPause)
    for mod in (jax_hls, hls):
        monkeypatch.setattr(mod, "retrieve_stac_metadata", mod.retrieve_stac_metadata.__wrapped__)
    monkeypatch.setattr(jax_stac, "_load_asset", jax_stac._load_asset.__wrapped__)
    monkeypatch.setattr(stac, "_load_asset", stac._load_asset.__wrapped__)
    monkeypatch.setattr(jax_stac.StacClient, "search", lambda self, **kw: [
        jax_stac.StacItem.from_dict(helpers.copy_item(world["item"]))])
    monkeypatch.setattr(stac.StacClient, "search", lambda self, **kw: [
        stac.StacItem.from_dict(helpers.copy_item(world["item"]))])
    out = {}
    for side, mod in (("jax", jax_settings), ("port", settings)):
        out[side] = {"tasks": str(tmp_path / side / "tasks"),
                     "db": str(tmp_path / side / "db.sqlite")}
        os.makedirs(out[side]["tasks"])
        monkeypatch.setattr(mod.settings, "TASKS_DATA_DIR", out[side]["tasks"])
        monkeypatch.setattr(mod.settings, "DATABASE_URL", out[side]["db"])
        monkeypatch.setattr(mod.settings, "AUTH_DISABLED", True)
    monkeypatch.setattr(settings.settings, "DEVICE", "cpu")
    jax_rcc.FLAGS.unparse_flags()
    yield out
    jax_rcc.FLAGS.unparse_flags()


def _port_request(base, method, path, body=None):
    data = None if body is None else (body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def _tile_xy(lon, lat, z):
    return (int((lon + 180) / 360 * 2 ** z),
            int((1 - math.asinh(math.tan(math.radians(lat))) / math.pi) / 2 * 2 ** z))


def _normal(value, task_id):
    """A JSON body with the task id replaced, times dropped and job
    function paths, arguments and results reduced to their function names."""
    if isinstance(value, dict):
        out = {k: _normal(v, task_id) for k, v in value.items() if k not in TIMES}
        if "func" in out:
            out["func"] = out["func"].split(":")[1]
            for k in ("args", "job_id", "result"):
                out.pop(k, None)
        return out
    if isinstance(value, list):
        return [_normal(v, task_id) for v in value]
    if isinstance(value, str):
        return value.replace(task_id, "<task>")
    return value


def _script(task_id, bbox_tiles):
    """The requests after the queues are drained: (method, path, body)."""
    out = [("GET", f"/api/task/{task_id}", None), ("GET", "/api/tasks", None),
           ("GET", "/api/queues/status", None), ("GET", "/api/jobs", None),
           ("GET", "/api/jobs?queue=model-prediction&status=finished&limit=2", None),
           ("GET", f"/api/visualize/{task_id}", None), ("GET", "/api/visualize/nope", None),
           ("GET", f"/api/titiler/{task_id}/nope/tilejson.json", None),
           ("GET", "/api/titiler/nope/chips/statistics", None)]
    for layer in ("chips", "predictions"):
        base = f"/api/titiler/{task_id}/{layer}"
        out += [("GET", f"{base}/tilejson.json", None), ("GET", f"{base}/statistics", None),
                ("GET", f"{base}/preview.png", None)]
        out += [("GET", f"{base}/tiles/{z}/{x}/{y}.png", None) for z, x, y in bbox_tiles]
    chips = f"/api/titiler/{task_id}/chips"
    z, x, y = bbox_tiles[-1]
    out += [("GET", f"{chips}/tiles/{z}/{x}/{y}.png?mode=gray&rescale=100,4000", None),
            ("GET", f"{chips}/preview.png?rescale=0,5000", None),
            ("GET", f"/api/titiler/{task_id}/predictions/tiles/{z}/{x}/{y}.png?colormap="
                    + urllib.request.quote(json.dumps({"0": [1, 2, 3], "1": [9, 8, 7, 6]})), None),
            ("GET", f"{chips}/tiles/{z}/{x}/bad.png", None)]
    return out


VALIDATION = [
    ("POST", "/api/run-model", {}),
    ("POST", "/api/run-model", {"bboxes": [[0, 0, 1, 1]]}),
    ("POST", "/api/run-model", {"bboxes": [[0, 0, 1, 1]], "model_key": "missing"}),
    ("POST", "/api/run-model", {"bboxes": [[0, 0, 1, 1]], "model_key": "toy_model",
                                "model_size": "huge"}),
    ("POST", "/api/run-model", [1, 2]),
    ("POST", "/api/run-model", {"bboxes": [[0, 0, 1, 1]], "model_key": "toy_model",
                                "parameters": [1]}),
    ("POST", "/api/run-model", b"{not json"),
    ("GET", "/api/models", None), ("GET", "/api/models/toy_model", None),
    ("GET", "/api/models/nope", None), ("GET", "/api/task/nope", None),
    ("GET", "/api/jobs?limit=x", None), ("GET", "/api/health", None),
]


def _jax_session(env, post, script_fn):
    """The JAX app: validation requests, the POST, a visualize before the
    stages ran, the drain, then the script. Returns (task id, responses)."""
    app = jax_main.create_app(db_path=env["jax"]["db"])

    async def go():
        out = []
        async with TestClient(TestServer(app)) as client:
            async def call(method, path, body):
                kw = {}
                if isinstance(body, bytes):
                    kw["data"] = body
                elif body is not None:
                    kw["json"] = body
                r = await client.request(method, path, **kw)
                return r.status, r.content_type, await r.read()

            for req in VALIDATION:
                out.append(await call(*req))
            status, _, body = await call("POST", "/api/run-model", post)
            task_id = json.loads(body)["task_id"]
            out.append((status, "application/json", body))
            out.append(await call("GET", f"/api/visualize/{task_id}", None))
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: jax_queue.drain(db_path=env["jax"]["db"]))
            for req in script_fn(task_id):
                out.append(await call(*req))
        return task_id, out

    return _run(go())


def _port_session(env, post, script_fn):
    app = create_app(db_path=env["port"]["db"])
    server = web.AppServer(app)
    base = f"http://127.0.0.1:{server.port}"
    try:
        out = [_port_request(base, *req) for req in VALIDATION]
        status, ctype, body = _port_request(base, "POST", "/api/run-model", post)
        task_id = json.loads(body)["task_id"]
        out.append((status, ctype, body))
        out.append(_port_request(base, "GET", f"/api/visualize/{task_id}"))
        queue.drain(db_path=env["port"]["db"])
        out += [_port_request(base, *req) for req in script_fn(task_id)]
    finally:
        server.close()
    return task_id, out


def _decided(world, chips_dir):
    """Per chip file name, the pixels whose port logits' top-2 gap is at
    least ``DECIDED_GAP``."""
    cfg = load_config("config", overrides={
        **helpers.model_overrides(), "device": "cpu", "checkpoint_path": world["ckpt"]})
    model = ModelServer(cfg).model
    out = {}
    for name in sorted(os.listdir(chips_dir)):
        with GeoTiffReader(os.path.join(chips_dir, name)) as r:
            raw = r.read()[None]
        x = preprocess_chips(raw_to_device(raw, torch.device("cpu")), torch.tensor(helpers.MEAN),
                             torch.tensor(helpers.STD), 1, torch.arange(6), 1.0,
                             img_size=helpers.CHIP)
        with torch.no_grad():
            top2 = model(x, channels_last=True).topk(2, dim=-1).values[0]
        out[name] = ((top2[..., 0] - top2[..., 1]) >= DECIDED_GAP).numpy()
    return out


def test_task_lifecycle_equals_jax(world, env):
    """The same POST and requests against both servers, the stages drained
    in process: see the module's docstring for what is held equal."""
    lon = (world["bbox"][0] + world["bbox"][2]) / 2
    lat = (world["bbox"][1] + world["bbox"][3]) / 2
    tiles = [(3, *_tile_xy(lon, lat, 3)), (12, *_tile_xy(lon, lat, 12)),
             (14, *_tile_xy(lon, lat, 14)), (14, *_tile_xy(world["bbox"][0], world["bbox"][3], 14))]
    script = lambda tid: _script(tid, tiles)  # noqa: E731
    post = {"bboxes": [world["bbox"]], "model_key": "toy_model",
            "parameters": {"date": "2024-06-01"}, "cloud_coverage": 20}
    jid, jout = _jax_session(env, post, script)
    pid, pout = _port_session(env, post, script)
    requests = VALIDATION + [("POST", "/api/run-model", post),
                             ("GET", "/api/visualize/<task>", None)] + script("<task>")
    assert len(jout) == len(pout) == len(requests)
    png_pixels = {"chips": 0, "predictions": [0, 0]}
    for (method, path, _), (js, jtype, jbody), (ps, ptype, pbody) in zip(requests, jout, pout):
        what = f"{method} {path}"
        assert js == ps, (what, jbody[:200], pbody[:200])
        if jtype == "image/png":
            assert ptype == "image/png", what
            a, b = _rgba(jbody), _rgba(pbody)
            assert a.shape == b.shape, what
            if "/chips/" in path:
                np.testing.assert_array_equal(a, b, err_msg=what)
                png_pixels["chips"] += a.shape[0] * a.shape[1]
            else:
                png_pixels["predictions"][0] += int((a == b).all(axis=-1).sum())
                png_pixels["predictions"][1] += a.shape[0] * a.shape[1]
            continue
        assert ptype.split(";")[0] == jtype, what
        if jtype != "application/json":
            continue
        jv, pv = _normal(json.loads(jbody), jid), _normal(json.loads(pbody), pid)
        if path.startswith("/api/task/<task>") or path == "/api/tasks":
            tasks = [jv, pv] if path != "/api/tasks" else [jv["tasks"][0], pv["tasks"][0]]
            stats = [t["stages"]["visualization_preparation"].pop("result")["segmentation_stats"]
                     for t in tasks]
            assert stats[0]["total_pixels"] == stats[1]["total_pixels"] > 0
            for c in set(stats[0]["class_counts"]) | set(stats[1]["class_counts"]):
                assert abs(stats[0]["class_counts"].get(c, 0) - stats[1]["class_counts"].get(c, 0)) \
                    <= (1 - AGREEMENT) * stats[0]["total_pixels"], (what, c)
        if path.endswith("/predictions/statistics"):
            for band in jv:
                for k in jv[band]:
                    assert pv[band][k] == pytest.approx(jv[band][k], abs=2 * (1 - AGREEMENT)), what
            continue
        if path.startswith("/api/health"):
            jv.pop("workers"), pv.pop("workers")
        assert jv == pv, what
    assert png_pixels["chips"] > 0
    assert png_pixels["predictions"][0] >= AGREEMENT * png_pixels["predictions"][1] > 0

    # Files: chips, manifest and bboxes byte for byte; predictions on decided pixels.
    jdir, pdir = (os.path.join(env[s]["tasks"], t) for s, t in (("jax", jid), ("port", pid)))
    chips = sorted(os.listdir(os.path.join(jdir, "chips")))
    assert chips and chips == sorted(os.listdir(os.path.join(pdir, "chips")))
    for rel in [os.path.join("chips", c) for c in chips] + ["hls_raster_dataset.csv",
                                                             "bounding_boxes.json"]:
        with open(os.path.join(jdir, rel), "rb") as a, open(os.path.join(pdir, rel), "rb") as b:
            assert a.read() == b.read(), rel
    with open(os.path.join(pdir, "hls_raster_dataset.csv")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "Input" and sorted(lines[1:]) == [f"chips/{c}" for c in chips]
    with open(os.path.join(jdir, f"{jid}_chips.tif"), "rb") as a, \
            open(os.path.join(pdir, f"{pid}_chips.tif"), "rb") as b:
        assert a.read() == b.read()
    decided = _decided(world, os.path.join(pdir, "chips"))
    same = total = 0
    for chip in chips:
        preds = []
        for d in (jdir, pdir):
            with JaxGeoTiffReader(os.path.join(d, "predictions",
                                               chip.replace("chip", "prediction"))) as r:
                preds.append(r.read(1))
        mask = decided[chip]
        assert mask.mean() > 0.9
        same += int((preds[0][mask] == preds[1][mask]).sum())
        total += int(mask.sum())
    assert same >= AGREEMENT * total


# ---------------------------------------------------------------------------
# COG writer, PNG, tiler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["uint16_rgb", "int16_nodata"])
def test_write_cog_equals_jax(tmp_path, case):
    rng = np.random.default_rng(3)
    if case == "uint16_rgb":
        arr, nodata = rng.integers(0, 10000, (3, 300, 260)).astype(np.uint16), 0
    else:
        arr, nodata = rng.integers(-1, 13, (1, 517, 129)).astype(np.int16), -1
    kw = dict(crs=32633, nodata=nodata, tile_size=64, num_overviews=6)
    jax_write_cog(str(tmp_path / "a.tif"), arr,
                  transform=JaxAffine.from_origin(399960.0, 4600020.0, 30.0, 30.0), **kw)
    write_cog(str(tmp_path / "b.tif"), arr,
              transform=Affine.from_origin(399960.0, 4600020.0, 30.0, 30.0), **kw)
    assert (tmp_path / "a.tif").read_bytes() == (tmp_path / "b.tif").read_bytes()
    with GeoTiffReader(str(tmp_path / "b.tif")) as r:
        assert len(r.ifds) > 2 and np.array_equal(r.read(), arr)
        assert np.array_equal(r.read(ifd_index=1), arr[:, ::2, ::2])


def test_png_encoder_round_trips():
    rgba = np.random.default_rng(4).integers(0, 256, (37, 53, 4)).astype(np.uint8)
    png = encode_png(rgba)
    np.testing.assert_array_equal(_rgba(png), rgba)
    img = Image.open(io.BytesIO(png))
    img.verify()  # chunk CRCs
    assert img.mode == "RGBA" and img.size == (53, 37)
    with pytest.raises(ValueError):
        encode_png(rgba[..., :3])


@pytest.fixture(scope="module")
def cogs(tmp_path_factory):
    """A UTM chips COG (3 uint16 bands, nodata 0 in a corner) and an
    EPSG:4326 predictions COG (int8, classes 0..6, nodata -1)."""
    root = tmp_path_factory.mktemp("cogs")
    rng = np.random.default_rng(5)
    chips = rng.integers(1, 5000, (3, 300, 300)).astype(np.uint16)
    chips[:, :40, :40] = 0
    write_cog(str(root / "chips.tif"), chips, transform=Affine.from_origin(
        500000.0, 4760000.0, 30.0, 30.0), crs=32633, nodata=0, tile_size=64)
    preds = rng.integers(0, 7, (1, 256, 256)).astype(np.int8)
    preds[:, 200:, :30] = -1
    write_cog(str(root / "predictions.tif"), preds, transform=Affine.from_origin(
        10.0, 45.0, 0.001, 0.001), crs=4326, nodata=-1, tile_size=64)
    return root


RENDERS = {
    "rgb": ("chips", dict(mode="rgb")),
    "rgb_rescale": ("chips", dict(mode="rgb", value_range=(100, 3000))),
    "gray": ("chips", dict(mode="gray")),
    "classes": ("predictions", dict(mode="classes")),
    "classes_colormap": ("predictions", dict(mode="classes", colormap={
        0: (1, 2, 3), 2: (200, 100, 50, 255), 5: (9, 9, 9)})),
}


@pytest.mark.parametrize("render", sorted(RENDERS))
def test_tiler_equals_jax(cogs, render):
    """Tiles over the raster at z 8..14 (inside, on its edge, outside), the
    preview, statistics and tilejson of the port's ``COGTiler`` equal the
    JAX tiler's (PNGs decoded)."""
    layer, kw = RENDERS[render]
    path = str(cogs / f"{layer}.tif")
    jt, pt = jax_tiler.COGTiler(path), tiler.COGTiler(path)
    b = pt.bounds_4326()
    assert b == jt.bounds_4326()
    n = 0
    for z in (8, 11, 14):
        for lon, lat in ((b[0], b[3]), ((b[0] + b[2]) / 2, (b[1] + b[3]) / 2), (b[2], b[1])):
            x, y = _tile_xy(lon, lat, z)
            a = _rgba(jt.render_tile(z, x, y, **kw))
            np.testing.assert_array_equal(_rgba(pt.render_tile(z, x, y, **kw)), a)
            n += int((a[..., 3] > 0).sum())
    assert n > 0
    for size in (512, 100):
        np.testing.assert_array_equal(_rgba(pt.preview(max_size=size, **kw)),
                                      _rgba(jt.preview(max_size=size, **kw)))
    assert pt.statistics() == jt.statistics()
    assert pt.tilejson("/t/{z}/{x}/{y}.png") == jt.tilejson("/t/{z}/{x}/{y}.png")
    jt.close(), pt.close()


def test_tiler_refuses_path_traversal(tmp_path):
    svc = tiler.TilerService(str(tmp_path))
    for bad in ("../../etc", "a/../b", "..", "", "a\x00b"):
        with pytest.raises(FileNotFoundError):
            svc.get_tiler(bad, "predictions")
        with pytest.raises(FileNotFoundError):
            svc.get_tiler("t1", bad)
        assert svc.visualize_urls(bad) == {}


def test_tiler_cache_invalidates_on_rewrite_and_evicts(tmp_path):
    svc = tiler.TilerService(str(tmp_path))

    def write(tid, value):
        (tmp_path / tid).mkdir(exist_ok=True)
        write_geotiff(str(tmp_path / tid / f"{tid}_predictions.tif"),
                      np.full((1, 8, 8), value, np.int8),
                      transform=Affine.from_origin(0, 1, 0.1, 0.1), crs=4326)

    write("t1", 1)
    first = svc.get_tiler("t1", "predictions")
    assert svc.get_tiler("t1", "predictions") is first
    time.sleep(0.01)
    write("t1", 2)
    os.utime(tmp_path / "t1" / "t1_predictions.tif")
    second = svc.get_tiler("t1", "predictions")
    assert second is not first and int(second._level(0)[0, 0, 0]) == 2
    for i in range(svc.MAX_CACHED + 3):
        write(f"e{i}", i)
        svc.get_tiler(f"e{i}", "predictions")
    assert len(svc._tilers) <= svc.MAX_CACHED
    assert svc.visualize_urls("t1") == jax_tiler.TilerService(str(tmp_path)).visualize_urls("t1")


def test_concurrent_tile_renders_are_consistent(tmp_path):
    """Renders on several threads of one fresh tiler (cold level cache, one
    shared reader) give the single-threaded tile."""
    rng = np.random.default_rng(0)
    p = str(tmp_path / "cog.tif")
    write_geotiff(p, rng.integers(0, 3000, (3, 256, 256)).astype(np.uint16),
                  transform=Affine.from_origin(0, 50, 0.001, 0.001), crs=4326)
    ref = tiler.COGTiler(p).render_tile(9, 255, 181)
    fresh = tiler.COGTiler(p)
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        outs = list(pool.map(lambda _: fresh.render_tile(9, 255, 181), range(12)))
    assert all(o == ref for o in outs)


def test_cog_converter_equals_jax(tmp_path):
    """``merge_task_files_to_cog`` and ``compute_seg_stats`` on the same
    chips and predictions: the same COG bytes and statistics."""
    from instageo_tpu.webapp.cog import COGConverter as JaxCOGConverter
    from instageo_tpu_torch.webapp.cog import COGConverter

    data = tmp_path / "task"
    os.makedirs(data / "predictions")
    os.makedirs(data / "chips")
    rng = np.random.default_rng(0)
    for i, (c, r) in enumerate([(0, 0), (1, 0), (0, 1)]):
        tr = Affine.from_origin(c * 960, 1920 - r * 960, 30, 30)
        write_geotiff(str(data / "predictions" / f"prediction_{i}.tif"),
                      rng.integers(-1, 3, (1, 32, 32)).astype(np.int8), transform=tr,
                      crs=32633, nodata=-1)
        write_geotiff(str(data / "chips" / f"chip_{i}.tif"),
                      rng.integers(1, 10000, (6, 32, 32)).astype(np.uint16), transform=tr,
                      crs=32633, nodata=0)
    out = {}
    for side, conv in (("jax", JaxCOGConverter), ("port", COGConverter)):
        c = conv(str(data), block_size=32, num_overviews=2)
        res = c.merge_task_files_to_cog(side)
        out[side] = ({k: open(v, "rb").read() for k, v in res.items()},
                     c.compute_seg_stats(res["predictions_cog"]))
    assert out["jax"] == out["port"]
    assert out["port"][1]["total_pixels"] > 0


# ---------------------------------------------------------------------------
# Auth
# ---------------------------------------------------------------------------


DOMAIN, AUD = "tenant.auth0.com", "https://api.example.com"


@pytest.fixture(scope="module")
def keys():
    crypto = pytest.importorskip("cryptography.hazmat.primitives.asymmetric.rsa")
    key = crypto.generate_private_key(public_exponent=65537, key_size=2048)
    other = crypto.generate_private_key(public_exponent=65537, key_size=2048)
    pub = key.public_key().public_numbers()

    def b64(data):
        import base64
        return base64.urlsafe_b64encode(data).rstrip(b"=").decode()

    jwk = {"kty": "RSA", "kid": "testkey", "use": "sig", "alg": "RS256",
           "n": b64(pub.n.to_bytes((pub.n.bit_length() + 7) // 8, "big")),
           "e": b64(pub.e.to_bytes(3, "big"))}
    return key, other, {"keys": [jwk]}, b64


def _token(key, b64, payload, kid="testkey", alg="RS256"):
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    h = b64(json.dumps({"alg": alg, "typ": "JWT", "kid": kid}).encode())
    p = b64(json.dumps(payload).encode())
    sig = key.sign(f"{h}.{p}".encode(), padding.PKCS1v15(), hashes.SHA256())
    return f"{h}.{p}.{b64(sig)}"


def _claims(**over):
    base = {"sub": "auth0|user1", "aud": AUD, "iss": f"https://{DOMAIN}/",
            "exp": time.time() + 3600}
    base.update(over)
    return {k: v for k, v in base.items() if v is not None}


def _tampered(key, other, b64):
    h, _, s = _token(key, b64, _claims()).split(".")
    return f"{h}.{b64(json.dumps(_claims(sub='auth0|attacker')).encode())}.{s}"


TOKENS = {
    "valid": lambda key, other, b64: _token(key, b64, _claims()),
    "audience_list": lambda key, other, b64: _token(key, b64, _claims(aud=["x", AUD])),
    "expired": lambda key, other, b64: _token(key, b64, _claims(exp=time.time() - 10)),
    "wrong_audience": lambda key, other, b64: _token(key, b64, _claims(aud="https://other")),
    "wrong_issuer": lambda key, other, b64: _token(key, b64, _claims(iss="https://evil/")),
    "no_issuer": lambda key, other, b64: _token(key, b64, _claims(iss=None)),
    "no_exp": lambda key, other, b64: _token(key, b64, _claims(exp=None)),
    "wrong_key": lambda key, other, b64: _token(other, b64, _claims()),
    "tampered": _tampered,
    "truncated_signature": lambda key, other, b64: _token(key, b64, _claims())[:-8],
    "unknown_kid": lambda key, other, b64: _token(key, b64, _claims(), kid="nope"),
    "alg_none": lambda key, other, b64: _token(key, b64, _claims()).rsplit(".", 1)[0]
    .replace(b64(b'{"alg": "RS256"'), b64(b'{"alg": "none"')) + ".",
    "malformed": lambda key, other, b64: "not-a-jwt",
}


@pytest.mark.parametrize("case", sorted(TOKENS))
def test_verify_jwt_equals_jax(keys, monkeypatch, case):
    key, other, jwks, b64 = keys
    token = TOKENS[case](key, other, b64)
    outcomes = []
    for mod in (jax_auth, auth):
        monkeypatch.setattr(mod, "get_jwks", lambda domain: jwks)
        monkeypatch.setattr(mod, "_last_jwks_refetch", {})
        try:
            outcomes.append(("claims", mod.verify_jwt(token, domain=DOMAIN, audience=AUD)))
        except mod.AuthError as e:
            outcomes.append(("error", str(e).split(":")[0], e.status))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1][0] == "claims") == (case in ("valid", "audience_list"))


def test_get_userinfo_retries_over_urllib(monkeypatch):
    """``get_userinfo`` retries a failed fetch (``URLError``) and then
    returns the JSON body."""
    calls = []

    def fake(url, headers=None):
        calls.append((url, headers))
        if len(calls) < 2:
            raise urllib.error.URLError("down")
        return {"email": "a@b.c"}

    monkeypatch.setattr(auth, "_get_json", fake)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    assert auth.get_userinfo("tok", domain="d.example") == {"email": "a@b.c"}
    assert calls[-1] == ("https://d.example/userinfo", {"Authorization": "Bearer tok"})


# ---------------------------------------------------------------------------
# Queue, data processor, docs, static files
# ---------------------------------------------------------------------------


JOBS = "tests.torch_webapp_helpers"


@pytest.fixture
def qdb(tmp_path):
    path = str(tmp_path / "q.sqlite")
    db.init_db(path)
    return path


def test_queue_claim_run_fail_and_reap(qdb):
    jid = queue.enqueue("data-processing", f"{JOBS}:_ok_job", {"value": 7}, db_path=qdb)
    job = queue.claim_next("data-processing", db_path=qdb)
    assert job["job_id"] == jid and queue.claim_next("data-processing", db_path=qdb) is None
    assert queue.run_job(job, db_path=qdb)
    assert queue.get_job(jid, db_path=qdb)["status"] == "finished"
    queue.enqueue("data-processing", f"{JOBS}:_boom", {}, db_path=qdb)
    assert queue.work_once("data-processing", db_path=qdb)
    assert queue.get_queues_status(qdb)["data-processing"]["failed"] == 1
    late = queue.enqueue("model-prediction", f"{JOBS}:_ok_job", {}, timeout_s=0.01, db_path=qdb)
    assert queue.claim_next("model-prediction", db_path=qdb) is not None
    time.sleep(0.05)
    assert queue.reap_timeouts(qdb) == 1
    assert queue.get_job(late, db_path=qdb)["status"] == "timed_out"
    queue.enqueue("visualization-preparation", f"{JOBS}:_ok_job", {}, db_path=qdb)
    assert queue.drain(db_path=qdb) == 1 and queue.drain(db_path=qdb) == 0
    assert [j["queue"] for j in queue.list_jobs(db_path=qdb)][0] == "visualization-preparation"


def test_isolated_hung_job_is_killed(qdb):
    """A hung job's spawned child is killed at its timeout and the queue
    goes on; an isolated job that succeeds records its result."""
    jid = queue.enqueue("model-prediction", f"{JOBS}:_hang", {}, timeout_s=0.5, db_path=qdb)
    ok = queue.enqueue("model-prediction", f"{JOBS}:_ok_job", {"value": 3}, db_path=qdb)
    t0 = time.monotonic()
    assert queue.work_once("model-prediction", db_path=qdb, isolate=True)
    assert time.monotonic() - t0 < 30
    assert queue.get_job(jid, db_path=qdb)["status"] == "timed_out"
    assert queue.work_once("model-prediction", db_path=qdb, isolate=True)
    rec = queue.get_job(ok, db_path=qdb)
    assert rec["status"] == "finished" and json.loads(rec["result"]) == {"value": 3}
    assert queue._mp.get_start_method() == "spawn"


PROCESSOR_FLAGS = ("output_directory", "is_bbox_feature", "bbox_feature_path", "date",
                   "data_source", "chip_size", "num_steps", "temporal_step",
                   "temporal_tolerance", "cloud_coverage", "spatial_resolution", "mask_types")


def test_data_processor_flags_equal_jax_without_leaks(tmp_path, monkeypatch):
    """Two tasks in a row (the first with ``mask_types``, the second
    without): the raster creator sees the JAX processor's flag values, plus
    ``--device`` from the settings; nothing of the first task leaks."""
    from instageo_tpu_torch.data import flags as port_flags

    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jax_rcc, "main", lambda argv: seen["jax"].append(
        {k: (list(v) if k == "mask_types" else v) for k in PROCESSOR_FLAGS
         for v in [getattr(jax_rcc.FLAGS, k)]}))

    def port_main(argv):
        ns = port_flags.parse_flags(argv, port_flags.COMMON_FLAGS + port_flags.RASTER_FLAGS)
        seen["port"].append({k: getattr(ns, k) for k in PROCESSOR_FLAGS + ("device",)})

    monkeypatch.setattr(raster_chip_creator, "main", port_main)
    monkeypatch.setattr(settings.settings, "DEVICE", "cpu")
    params = [{"chip_size": 96, "mask_types": ["cloud", "water"], "date": "2024-05-01",
               "temporal_step": 20, "cloud_coverage": 15},
              {"chip_size": 224, "data_source": "S2"}]
    try:
        for i, p in enumerate(params):
            for side, proc in (("jax", jax_dp.DataProcessor), ("port", DataProcessor)):
                proc(str(tmp_path / side / str(i)), p).extract_data_from_bboxes([[0, 0, 1, 1]])
    finally:
        jax_rcc.FLAGS.unparse_flags()
    for j, p in zip(seen["jax"], seen["port"]):
        assert p.pop("device") == "cpu"
        assert p == {**j, "output_directory": j["output_directory"].replace("jax", "port"),
                     "bbox_feature_path": j["bbox_feature_path"].replace("jax", "port")}
    assert seen["port"][1]["mask_types"] == []


def test_manifest_rewrite_bytes_equal_jax(tmp_path, monkeypatch):
    """The raster manifest (an unnamed index column, absolute ``Input``
    paths, here also a float column with a NaN) rewritten as the JAX
    processor's pandas does: the same bytes."""
    import pandas as pd

    monkeypatch.setattr(jax_rcc, "main", lambda argv: None)
    monkeypatch.setattr(raster_chip_creator, "main", lambda argv: None)
    monkeypatch.setattr(settings.settings, "DEVICE", "cpu")
    out = {}
    try:
        for side, proc in (("jax", jax_dp.DataProcessor), ("port", DataProcessor)):
            d = str(tmp_path / "task")
            os.makedirs(os.path.join(d, "chips"), exist_ok=True)
            for i in range(3):
                open(os.path.join(d, "chips", f"chip_{i}.tif"), "w").close()
            pd.DataFrame({"Input": [os.path.join(d, "chips", f"chip_{i}.tif") for i in range(3)],
                          "Score": [0.1, float("nan"), 1e-05]}).to_csv(
                os.path.join(d, "hls_raster_dataset.csv"))
            res = proc(d, {}).extract_data_from_bboxes([[0, 0, 1, 1]])
            assert res["chip_count"] == 3
            with open(res["dataset_csv"], "rb") as f:
                out[side] = f.read()
    finally:
        jax_rcc.FLAGS.unparse_flags()
    assert out["jax"] == out["port"]
    assert out["port"].startswith(b"Input,Score\nchips/chip_0.tif,0.1\n")


def test_openapi_docs_and_routes_equal_jax(tmp_path):
    assert docs.build_openapi_spec() == jax_docs.build_openapi_spec()
    spec = docs.build_openapi_spec()
    assert docs._render_docs_html(spec) == jax_docs._render_docs_html(spec)
    jax_app = jax_main.create_app(db_path=str(tmp_path / "j.sqlite"))
    jax_routes = set()
    for r in jax_app.router.routes():
        info = r.resource.get_info() if r.resource else {}
        path = info.get("path") or info.get("formatter") or info.get("prefix")
        if r.method in ("GET", "POST"):
            jax_routes.add((r.method, path))
    app = create_app(db_path=str(tmp_path / "p.sqlite"))
    routes = set(app.routes()) | {("GET", prefix.rstrip("/")) for prefix, _ in app._static}
    assert routes == jax_routes
    api = {(m.lower(), p) for m, p in routes if p.startswith("/api")}
    assert api - {("get", "/api/docs"), ("get", "/api/openapi.json")} == {
        (m, p) for p, ms in spec["paths"].items() for m in ms}


def test_selftest_goldens_and_static_files_equal_jax():
    assert selftest_goldens.generate() == jax_goldens.generate()
    ours = os.path.join(os.path.dirname(selftest_goldens.__file__), "static")
    theirs = os.path.join(os.path.dirname(jax_goldens.__file__), "static")

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    assert files(ours) == files(theirs) and len(files(ours)) >= 20
    for rel in files(ours):
        with open(os.path.join(ours, rel), "rb") as a, open(os.path.join(theirs, rel), "rb") as b:
            assert a.read() == b.read(), rel
    with open(os.path.join(ours, "selftest_goldens.json")) as f:
        assert json.load(f) == json.loads(json.dumps(selftest_goldens.generate()))


@pytest.mark.parametrize("configured", [False, True])
def test_spa_pages_equal_jax(tmp_path, monkeypatch, configured):
    """``/``, ``/dashboard`` and a static file: the same bodies as the JAX
    app's, with and without the deployment's Auth0 and API-base settings."""
    if configured:
        for mod in (jax_settings, settings):
            monkeypatch.setattr(mod.settings, "AUTH0_DOMAIN", "t.auth0.com")
            monkeypatch.setattr(mod.settings, "AUTH0_CLIENT_ID", "cid123")
            monkeypatch.setattr(mod.settings, "AUTH0_AUDIENCE", "https://api")
            monkeypatch.setattr(mod.settings, "API_BASE_URL", "https://api.example.com")
    paths = ["/", "/dashboard", "/static/js/config.js", "/static/nope.js", "/static/../main.py"]
    app = jax_main.create_app(db_path=str(tmp_path / "j.sqlite"))

    async def go():
        async with TestClient(TestServer(app)) as client:
            out = []
            for p in paths:
                r = await client.get(p)
                out.append((r.status, await r.read()))
            return out

    jax_out = _run(go())
    server = web.AppServer(create_app(db_path=str(tmp_path / "p.sqlite")))
    try:
        port_out = [_port_request(f"http://127.0.0.1:{server.port}", "GET", p)[::2]
                    for p in paths]
    finally:
        server.close()
    assert [s for s, _ in port_out] == [s for s, _ in jax_out] == [200, 200, 200, 404, 404]
    assert port_out[:3] == jax_out[:3]
    assert (b"window.INSTAGEO_AUTH0 = {" in port_out[0][1]) == configured


def test_auth_required_and_token_query(tmp_path, monkeypatch):
    """With auth on, the API answers 401 without a token (tile routes take
    ``?access_token=``), the public routes answer, and a task of another
    user is forbidden."""
    monkeypatch.setattr(settings.settings, "AUTH_DISABLED", False)
    monkeypatch.setattr(auth, "get_jwks", lambda domain: {"keys": []})
    users = {"tok-a": {"sub": "a"}, "tok-b": {"sub": "b"}}

    def current_user(token):
        if token not in users:
            raise auth.AuthError("Signing key not found")
        return users[token]

    import instageo_tpu_torch.webapp.main as main_mod

    monkeypatch.setattr(main_mod, "get_current_user", current_user)
    dbp = str(tmp_path / "a.sqlite")
    app = create_app(db_path=dbp)
    from instageo_tpu_torch.webapp.tasks import Task

    Task(task_id="t1", user_sub="a", db_path=dbp).save()
    server = web.AppServer(app)
    base = f"http://127.0.0.1:{server.port}"

    def get(path, token=None):
        req = urllib.request.Request(base + path, headers={"Authorization": f"Bearer {token}"}
                                     if token else {})
        try:
            with urllib.request.urlopen(req) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        assert get("/api/tasks") == (401, {"detail": "Missing bearer token"})
        assert get("/api/health")[0] == 200 and get("/api/openapi.json")[0] == 200
        assert get("/api/tasks", "bad") == (401, {"detail": "Signing key not found"})
        assert get("/api/task/t1", "tok-a")[0] == 200
        assert get("/api/task/t1", "tok-b") == (403, {"detail": "Forbidden"})
        assert get("/api/titiler/t1/chips/statistics?access_token=tok-b") == \
            (403, {"detail": "Forbidden"})
        assert get("/api/titiler/t1/chips/statistics?access_token=tok-a")[0] == 404
        assert get("/api/task/t1?access_token=tok-a")[0] == 401
    finally:
        server.close()


# ---------------------------------------------------------------------------
# The device
# ---------------------------------------------------------------------------


def test_stages_on_cuda_without_a_card_fail_the_task(world, env, monkeypatch):
    """``INSTAGEO_DEVICE=cuda`` and no card: stage 1 fails its task naming
    CUDA; with stage 1 run on the CPU, stage 2 fails the task naming CUDA.
    Nothing runs on the CPU in their place."""
    from instageo_tpu_torch.webapp.tasks import Task

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dbp = env["port"]["db"]
    db.init_db(dbp)
    for failing in ("data_processing", "model_prediction"):
        task = Task(bboxes=[world["bbox"]], parameters={"date": "2024-06-01", "chip_size": 32,
                                                       "num_steps": 1},
                    model_key="toy_model", model_size="base", db_path=dbp)
        task.save()
        monkeypatch.setattr(settings.settings, "DEVICE",
                            "cuda" if failing == "data_processing" else "cpu")
        task.start_data_processing()
        assert queue.work_once(queue.QUEUE_DATA_PROCESSING, db_path=dbp)
        monkeypatch.setattr(settings.settings, "DEVICE", "cuda")
        if failing == "model_prediction":
            assert queue.work_once(queue.QUEUE_MODEL_PREDICTION, db_path=dbp)
        rec = Task.load(task.task_id, dbp)
        assert rec.status == "failed" and "CUDA" in rec.stages[failing]["error"], rec.stages
        assert rec.stages[failing]["status"] == "failed"
        assert not os.path.exists(os.path.join(rec.data_dir, "predictions"))
    assert queue.drain(db_path=dbp) == 0


def test_server_imports_no_torch_and_module_entry_answers(tmp_path):
    """A fresh interpreter that makes the app and answers a request has not
    imported torch; ``python -m instageo_tpu_torch.webapp.main`` with its
    three workers answers ``/api/health`` and ``/api/models`` and stops on
    SIGTERM, its workers with it."""
    env = {**os.environ, "TESTING": "true", "DATABASE_URL": str(tmp_path / "m.sqlite"),
           "TASKS_DATA_DIR": str(tmp_path / "tasks")}
    code = ("import sys, urllib.request\n"
            "from instageo_tpu_torch.webapp import web\n"
            "from instageo_tpu_torch.webapp.main import create_app\n"
            "s = web.AppServer(create_app())\n"
            "urllib.request.urlopen(f'http://127.0.0.1:{s.port}/api/models').read()\n"
            "s.close()\n"
            "assert 'torch' not in sys.modules, 'the server imported torch'\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=60)
    # PORT=0: the server binds a free port and logs it ("Serving on ...").
    proc = subprocess.Popen([sys.executable, "-m", "instageo_tpu_torch.webapp.main"], cwd=ROOT,
                            env={**env, "PORT": "0"}, stderr=subprocess.PIPE, text=True)
    err_lines, bound, serving = [], {}, threading.Event()

    def read_stderr():
        for line in proc.stderr:
            err_lines.append(line)
            if "Serving on http://" in line and not serving.is_set():
                bound["port"] = int(line.rsplit(":", 1)[1])
                serving.set()

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    try:
        assert serving.wait(60), "".join(err_lines)
        port = bound["port"]
        health = None
        for _ in range(300):
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/health") as r:
                    health = json.loads(r.read())
                if health["workers"]["alive"] == 3:
                    break
            except (urllib.error.URLError, ConnectionError):
                pass
            time.sleep(0.1)
        assert health and health["status"] == "healthy" and health["workers"] == {
            "count": 3, "alive": 3}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/models") as r:
            assert [m["model_key"] for m in json.loads(r.read())["models"]] == [
                "flood_mapping", "crop_classification"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    err = "".join(err_lines)
    assert "Traceback" not in err, err
