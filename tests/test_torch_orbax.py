"""The port's orbax directory reader and writer (``train/orbax_dir.py``)
against orbax and tensorstore.

* ``read_tree`` equals ``ocp.StandardCheckpointer().restore`` leaf for leaf
  (dtype, shape, bits; lists, None, empty dicts) on directories the JAX
  package's ``BestCheckpointer`` writes: hypothesis-drawn trees of float32
  and int32 leaves with scalars, a tree of 2,500 leaves, leaves on both
  sides of orbax's 1024-byte inline limit, the plain layout (orbax with
  ``use_ocdbt=False``) and the optax AdamW trees of the JAX optimizer;
* orbax's B+tree holds 5,000 keys in one leaf node (its node limit is
  100 MB), so interior nodes, the version tree, numbered manifests and
  uncompressed nodes are held against tensorstore's own OCDBT stores with
  small limits: every key and value, and every generation;
* zarr v2 beyond what orbax writes (a grid of chunks with either
  ``dimension_separator``, edge chunks, an absent chunk's ``fill_value``,
  float16 and bfloat16) against tensorstore's zarr driver;
* a flipped byte in a node or a manifest raises, a missing ``libzstd``
  raises naming it;
* ``write_tree`` -> ``restore`` equal, the older directory replaced;
* the committed fixture (``tools/gen_torch_orbax_fixture.py``) in a fresh
  interpreter where JAX cannot be imported.
"""

import os
import subprocess
import sys
import types

import jax
import ml_dtypes
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from instageo_tpu.train.checkpointing import BestCheckpointer as JaxBestCheckpointer
from instageo_tpu.train.optim import make_optimizer as jax_make_optimizer
from instageo_tpu_torch.train import orbax_dir
from instageo_tpu_torch.train.orbax_dir import (
    OcdbtStore,
    OrbaxFormatError,
    read_tree,
    read_zarr,
    write_tree,
)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE = os.path.join(REPO, "tests", "torch_fixtures", "orbax_jax")


def assert_same_tree(ours, ref, path="root"):
    """Equal structure (dicts, lists, None) and leaves equal bit for bit,
    with their dtype and shape."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref), (path, ours, ref)
        for k in ref:
            assert_same_tree(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(ours, list) and len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            assert_same_tree(a, b, f"{path}/{i}")
    elif ref is None:
        assert ours is None, path
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray), path
        want = ref.astype(np.float32) if ref.dtype == ml_dtypes.bfloat16 else ref
        assert ours.dtype == want.dtype and ours.shape == want.shape, path
        np.testing.assert_array_equal(ours, want, err_msg=path)
    else:
        assert type(ours) is type(ref) and ours == ref, path


def jax_save(root, params, opt_state=None, batch_stats=None, step=7):
    ckpt = JaxBestCheckpointer(str(root))
    ckpt.save(types.SimpleNamespace(step=np.int32(step), params=params,
                                    batch_stats=batch_stats or {}, opt_state=opt_state))
    return ckpt.path


def restore(path):
    return ocp.StandardCheckpointer().restore(os.path.abspath(path))


# --- orbax directories -------------------------------------------------------

_leaf = st.one_of(
    st.builds(lambda shape, seed: np.random.default_rng(seed).standard_normal(shape)
              .astype(np.float32),
              st.lists(st.integers(1, 5), max_size=3).map(tuple), st.integers(0, 99)),
    st.builds(lambda shape, seed: np.random.default_rng(seed).integers(-999, 999, shape)
              .astype(np.int32),
              st.lists(st.integers(1, 5), max_size=3).map(tuple), st.integers(0, 99)))
_names = st.text("abcdefghij_", min_size=1, max_size=6)
_trees = st.recursive(_leaf, lambda kids: st.dictionaries(_names, kids, min_size=1,
                                                          max_size=4), max_leaves=12)


@settings(max_examples=12, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(params=st.dictionaries(_names, _trees, min_size=1, max_size=4))
def test_read_tree_equals_orbax_on_drawn_trees(tmp_path_factory, params):
    path = jax_save(tmp_path_factory.mktemp("drawn"), params)
    assert_same_tree(read_tree(path), restore(path))


def test_many_leaves_and_both_sides_of_the_inline_limit(tmp_path, monkeypatch):
    """2,500 small leaves and four larger ones, two of which compress under
    1024 bytes and two over: some values inline, some by reference."""
    rng = np.random.default_rng(1)
    params = {f"k{i:05d}": rng.standard_normal(3).astype(np.float32) for i in range(2500)}
    for n in (200, 240, 300, 400):  # 800 .. 1600 bytes of float32 noise
        params[f"big{n}"] = rng.standard_normal(n).astype(np.float32)
    path = jax_save(tmp_path, params)
    reads = []
    real = OcdbtStore._read

    def counting(self, rel, offset, length):
        reads.append(rel)
        return real(self, rel, offset, length)

    monkeypatch.setattr(OcdbtStore, "_read", counting)
    ours = read_tree(path)
    assert_same_tree(ours, restore(path))
    by_reference = [r for r in reads if r.startswith("ocdbt.process_")]
    assert 1 <= len(by_reference) < 4  # the others inline in the leaf node


@pytest.mark.parametrize("layout", ["ocdbt", "plain"])
def test_read_tree_select_reads_only_those_keys(tmp_path, monkeypatch, layout):
    """``select``: the tree of the named top-level keys alone, equal to
    orbax's; an OCDBT store reads no value held by reference for another
    key."""
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal(600).astype(np.float32)}
    moments = {"w": rng.standard_normal(600).astype(np.float32)}
    opt_state = [{"count": np.int32(2), "mu": moments, "nu": moments}, None, None]
    if layout == "ocdbt":
        path = jax_save(tmp_path, params, opt_state=opt_state)
    else:
        path = write_tree(str(tmp_path / "plain"), {"step": np.int32(7), "params": params,
                                                    "batch_stats": {}, "opt_state": opt_state})
    reads = []
    real = OcdbtStore._read

    def counting(self, rel, offset, length):
        reads.append(rel)
        return real(self, rel, offset, length)

    monkeypatch.setattr(OcdbtStore, "_read", counting)
    got = read_tree(path, ("params", "step"))
    ref = restore(path)
    assert_same_tree(got, {"params": ref["params"], "step": ref["step"]})
    if layout == "ocdbt":
        assert len([r for r in reads if r.startswith("ocdbt.process_")]) == 1


@pytest.mark.parametrize("scheduler,freeze", [(False, False), (True, False), (False, True),
                                              (True, True)])
def test_read_tree_equals_orbax_on_optax_states(tmp_path, scheduler, freeze):
    params = {"prithvi_encoder": {"w": np.ones((2, 3), np.float32)},
              "head": {"b": np.arange(4, dtype=np.float32)}}
    tx = jax_make_optimizer(params, 1e-3, scheduler=scheduler, steps_per_epoch=3,
                            freeze_backbone=freeze)
    path = jax_save(tmp_path, params, opt_state=tx.init(params),
                    batch_stats={"bn": {"mean": np.zeros(2, np.float32)}})
    assert_same_tree(read_tree(path), restore(path))


def test_plain_layout_equals_orbax(tmp_path):
    tree = {"step": np.int32(3), "params": {"a": {"kernel": np.ones((3, 4), np.float32)},
                                            "s": np.asarray(2.5, np.float32)},
            "opt": [None, {"c": np.int32(1)}], "e": {}}
    path = str(tmp_path / "plain")
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(
        path, args=ocp.args.PyTreeSave(tree))
    assert not os.path.exists(os.path.join(path, "manifest.ocdbt"))
    assert_same_tree(read_tree(path), restore(path))


# --- OCDBT stores of tensorstore ---------------------------------------------

def _ts_store(root, n, commits, **config):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": config}).result()
    rng = np.random.default_rng(n)
    items = {}
    keys = [f"key{i:06d}/x" for i in range(n)]
    per = max(1, n // commits)
    for start in range(0, n, per):
        with ts.Transaction() as txn:
            for k in keys[start:start + per]:
                items[k] = rng.bytes(int(rng.integers(0, 300)))
                kv.with_transaction(txn)[k] = items[k]
    return items


@pytest.mark.parametrize("case", ["interior", "versions", "uncompressed", "numbered"])
def test_ocdbt_store_equals_tensorstore(tmp_path, case):
    """Every key and value of the newest version, and every generation:
    interior B+tree nodes (300-byte node limit), a version tree of 301
    generations (arity 16, nodes of height 1 and 2), uncompressed nodes,
    numbered manifests."""
    config = {"max_inline_value_bytes": 100}
    n, commits = 60, 1
    if case == "interior":
        config["max_decoded_node_bytes"] = 300
    elif case == "versions":
        n, commits = 300, 300
        config["compression"] = None
    elif case == "uncompressed":
        config["compression"] = None
    else:
        config["manifest_kind"] = "numbered"
        n, commits = 20, 4
    items = _ts_store(str(tmp_path), n, commits, **config)
    with OcdbtStore(str(tmp_path)) as store:
        assert store.items() == items
        gens = store.generations()
        root_height = store.versions[-1]["height"]
    assert gens == list(range(1, gens[-1] + 1))
    if case == "numbered":  # the newest manifest.<generation> file is read
        assert gens[-1] == max(int(f.split(".")[1], 16) for f in os.listdir(tmp_path)
                               if f.startswith("manifest.0"))
    else:  # the empty first version, then one per commit
        assert gens[-1] == commits + 1
    if case == "interior":
        assert root_height >= 2


def _flip(path, where):
    data = bytearray(open(path, "rb").read())
    data[where(len(data))] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(data))


@pytest.mark.parametrize("part", ["node", "manifest"])
def test_flipped_byte_raises(tmp_path, part):
    path = jax_save(tmp_path, {"a": np.ones(3, np.float32)})
    if part == "node":
        node = os.path.join(path, "d", os.listdir(os.path.join(path, "d"))[0])
        _flip(node, lambda n: n // 2)
    else:
        _flip(os.path.join(path, "manifest.ocdbt"), lambda n: 20)
    with pytest.raises(OrbaxFormatError, match="crc32c"):
        read_tree(path)


def test_missing_libzstd_raises_naming_it(monkeypatch):
    monkeypatch.setattr(orbax_dir, "_zstd", None)
    monkeypatch.setattr(orbax_dir.ctypes.util, "find_library", lambda name: None)
    monkeypatch.setattr(orbax_dir, "ZSTD_LIBRARY", "libzstd.so.missing")

    def refuse(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(orbax_dir.ctypes, "CDLL", refuse)
    with pytest.raises(OSError, match="libzstd.so.missing"):
        read_tree(FIXTURE)


# --- zarr v2 -------------------------------------------------------------------

@pytest.mark.parametrize("dtype,sep", [("<f4", "."), ("<i4", "/"), ("<f2", "."),
                                       ("bfloat16", "/")])
def test_zarr_chunk_grid_equals_tensorstore(tmp_path, dtype, sep):
    """A 7×10 array in 3×4 chunks (edge chunks cut), one chunk never
    written (``fill_value``), zstd or no compressor."""
    for compressor in (None, {"id": "zstd", "level": 1}):
        root = tmp_path / f"z{compressor is None}"
        arr = ts.open({"driver": "zarr", "kvstore": f"file://{root}/a",
                       "metadata": {"shape": [7, 10], "chunks": [3, 4], "dtype": dtype,
                                    "fill_value": 2, "compressor": compressor,
                                    "dimension_separator": sep}},
                      create=True).result()
        values = (np.arange(70).reshape(7, 10) % 13 - 6).astype(
            ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype))
        arr[:, :8] = values[:, :8]  # the chunks of columns 8-9 stay absent
        want = values.copy()
        want[:, 8:] = 2

        def get(key, base=root):
            full = os.path.join(base, *key.split("/"))
            return open(full, "rb").read() if os.path.isfile(full) else None

        got = read_zarr(get, "a")
        ref = arr.read().result()
        np.testing.assert_array_equal(ref.astype(np.float64), want.astype(np.float64))
        assert got.dtype == (np.float32 if dtype == "bfloat16" else np.dtype(dtype))
        np.testing.assert_array_equal(got, ref.astype(got.dtype))


# --- the writer ----------------------------------------------------------------

def test_write_tree_restores_in_orbax_and_replaces(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"step": np.int32(5),
            "params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                       "s": np.asarray(1.5, np.float32), "n": np.int32(-2),
                       "h": rng.standard_normal(5).astype(np.float16)},
            "batch_stats": {},
            "opt_state": [{"count": np.int32(5), "mu": {"w": np.ones((4, 3), np.float32)}},
                          None, {"count": np.int32(5)}]}
    path = str(tmp_path / "ckpt")
    write_tree(path, {"step": np.int32(1), "params": {"old": np.zeros(2, np.float32)}})
    write_tree(path, tree, {"epoch": 3})
    ref = restore(path)
    assert_same_tree(ref, jax.tree.map(np.asarray, tree))  # scalars as 0-d arrays
    assert_same_tree(read_tree(path), ref)
    assert orbax_dir.checkpoint_custom_metadata(path) == {"epoch": 3}
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


# --- the committed fixture -----------------------------------------------------

def test_fixture_reads_without_jax():
    """The fixture, read in an interpreter where importing JAX fails, equals
    its expected arrays; orbax here restores the same tree."""
    script = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'orbax', 'tensorstore'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from instageo_tpu_torch.train.orbax_dir import read_tree\n"
        "def flat(node, path=()):\n"
        "    if isinstance(node, dict):\n"
        "        for k, v in node.items(): yield from flat(v, path + (str(k),))\n"
        "    elif isinstance(node, list):\n"
        "        for i, v in enumerate(node): yield from flat(v, path + (str(i),))\n"
        "    else: yield '/'.join(path), node\n"
        f"got = dict(flat(read_tree({FIXTURE!r})))\n"
        f"want = np.load({FIXTURE + '.npz'!r})\n"
        "nones = set(want['__none__'].tolist())\n"
        "assert {k for k, v in got.items() if v is None} == nones\n"
        "arrays = {k for k in want.files if k != '__none__'}\n"
        "assert {k for k, v in got.items() if v is not None} == arrays\n"
        "for k in arrays:\n"
        "    assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k\n"
        "    assert np.array_equal(got[k], want[k]), k\n"
        "print(len(arrays))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) >= 100
    assert_same_tree(read_tree(FIXTURE), restore(FIXTURE))
