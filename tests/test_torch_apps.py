"""The port's map viewer (``instageo_tpu_torch/apps``) against the JAX
package's (``instageo_tpu/apps``).

The same prediction GeoTIFFs (float32 probabilities with nodata, in
EPSG:4326 and in UTM 37S) go through both: the thresholded overlays are
equal array for array (RGBA uint8) with the same WGS84 bounds; the map HTML
is the same text once each overlay's PNG is decoded (the PNG bytes differ
from PIL's, the pixels do not); the browse (``find_prediction_tiles`` over
the dated and flat layouts, with and without a country) and the country
table lookups give the same lists; the CLI with absl's spellings writes the
same map.
"""

import base64
import io
import json
import os
import re

import numpy as np
import pytest
from PIL import Image

from instageo_tpu.apps import app as jax_app
from instageo_tpu.apps import viz as jax_viz
from instageo_tpu.data.geotiff import Affine, write_geotiff
from instageo_tpu_torch.apps import app, viz


def _write(path, crs, seed=0, size=(64, 48)):
    rng = np.random.default_rng(seed)
    arr = rng.uniform(0, 1, size=size).astype(np.float32)
    arr[0, :3] = -1  # nodata
    if crs == 4326:
        tr = Affine.from_origin(36.8, -1.2, 0.001, 0.001)
    else:
        tr = Affine.from_origin(300000.0, 9870000.0, 30.0, 30.0)
    write_geotiff(str(path), arr[None], transform=tr, crs=crs, nodata=-1)
    return str(path)


@pytest.mark.parametrize("crs", [4326, 32737])
@pytest.mark.parametrize("threshold", [(0.8, 1.0), (0.0, 0.2)])
def test_overlay_equals_jax(tmp_path, crs, threshold):
    path = _write(tmp_path / "prediction_20230601_T37MDT_0_0.tif", crs)
    got, bounds = viz.read_geotiff_to_overlay(path, threshold=threshold)
    want, want_bounds = jax_viz.read_geotiff_to_overlay(path, threshold=threshold)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert bounds == want_bounds
    assert (got[..., 3] > 0).any() and (got[..., 3] == 0).any()
    values = np.array([np.nan, 0.1, 0.5, 0.95, 1.0])
    np.testing.assert_array_equal(viz._reds_colormap(values, *threshold),
                                  jax_viz._reds_colormap(values, *threshold))


def _decoded(html):
    """The map HTML with each overlay's PNG replaced by its decoded pixels."""
    overlays = json.loads(re.search(r"var overlays = (\[.*?\]);\n", html).group(1))
    pixels = [np.asarray(Image.open(io.BytesIO(base64.b64decode(o.pop("png")))).convert("RGBA"))
              for o in overlays]
    return re.sub(r"var overlays = \[.*?\];\n", "", html), overlays, pixels


def test_map_html_equals_jax(tmp_path):
    paths = [_write(tmp_path / "prediction_20230601_T37MDT_0_0.tif", 4326),
             _write(tmp_path / "prediction_20230601_T37MDT_1_0.tif", 32737, seed=1),
             str(tmp_path / "missing.tif")]
    ours = _decoded(open(viz.create_map_with_geotiff_tiles(paths, str(tmp_path / "a.html"))).read())
    theirs = _decoded(open(jax_viz.create_map_with_geotiff_tiles(
        paths, str(tmp_path / "b.html"))).read())
    assert ours[0] == theirs[0] and ours[1] == theirs[1] and len(ours[2]) == 2
    for a, b in zip(ours[2], theirs[2]):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def layout(tmp_path):
    """Predictions in the dated layouts (``2023/06``, ``2023/6``) and flat."""
    for rel in ("2023/06/prediction_T37MDT_a.tif", "2023/06/prediction_T30PVT_b.tif",
                "2023/6/prediction_T37MDT_c.tif", "2022/11/prediction_T37MDT_d.tif",
                "prediction_T37MDT_e.tif", "prediction_T30PVT_f.tif"):
        os.makedirs(os.path.dirname(tmp_path / rel), exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    return str(tmp_path)


@pytest.mark.parametrize("query", [dict(), dict(year=2023, month=6), dict(year=2023),
                                   dict(year=2022, month=11, country_code="KE"),
                                   dict(country_code="ke"), dict(country_code="ML"),
                                   dict(year=2024, month=1)])
def test_find_prediction_tiles_equals_jax(layout, query):
    got = app.find_prediction_tiles(layout, **query)
    assert got == jax_app.find_prediction_tiles(layout, **query)


def test_country_tiles_equal_jax():
    with open(os.path.join(os.path.dirname(jax_app.__file__), "utils",
                           "country_code_to_mgrs_tiles.json")) as f:
        table = json.load(f)
    assert len(table) >= 76
    for code in list(table) + ["ke", "ZZ"]:
        assert app.load_country_tiles(code) == jax_app.load_country_tiles(code)


def test_cli_writes_the_jax_map(tmp_path):
    """``main`` with absl's spellings (``--flag value``, ``--flag=value``)
    writes the map the JAX CLI writes from the same flags."""
    d = tmp_path / "preds" / "2023" / "06"
    os.makedirs(d)
    _write(d / "prediction_T37MDT_0.tif", 4326)
    args = [f"--directory={tmp_path / 'preds'}", "--country_code", "KE", "--year=2023",
            "--month", "6", "--threshold_low=0.5"]
    app.main(args + [f"--output={tmp_path / 'a.html'}"])
    jax_app.FLAGS.unparse_flags()
    try:
        jax_app.FLAGS(["app"] + args + [f"--output={tmp_path / 'b.html'}"])
        jax_app.main(None)
    finally:
        jax_app.FLAGS.unparse_flags()
    ours, theirs = (_decoded(open(tmp_path / n).read()) for n in ("a.html", "b.html"))
    assert ours[:2] == theirs[:2] and len(ours[2]) == 1
    np.testing.assert_array_equal(ours[2][0], theirs[2][0])
    with pytest.raises(ValueError, match="--directory"):
        app.main([])
