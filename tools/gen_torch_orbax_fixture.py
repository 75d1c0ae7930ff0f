"""Write the orbax fixture that the port's checkpoint reader is held to where
JAX is missing (``tests/torch_fixtures/orbax_jax/``) and its expected arrays
(``orbax_jax.npz``).

The directory is what the JAX package's ``BestCheckpointer`` writes (an
OCDBT store, zstd-compressed manifests, nodes and chunks) for a synthetic
tree of about 100 arrays, some 200 keys in the store (each array a
``.zarray`` and a chunk): float32, int32, float16 and bfloat16 leaves,
scalars, an optax-like ``opt_state`` list with None entries, small values held inline
in a B+tree leaf and larger ones by reference in a data file. The ``.npz``
holds each array leaf under its key path joined with ``/`` (bfloat16 as the
float32 it converts to exactly) and, under ``__none__``, the paths of the
None leaves. ``chip_smoke.py`` and
``tests/test_torch_orbax.py::test_fixture_reads_without_jax`` read the
directory through ``instageo_tpu_torch.train.orbax_dir.read_tree`` and hold
it to them. Needs JAX and orbax:

    python tools/gen_torch_orbax_fixture.py
"""

from __future__ import annotations

import os
import shutil
import sys
import types

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from instageo_tpu.train.checkpointing import BestCheckpointer  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tests",
                   "torch_fixtures")
NAME = "orbax_jax"


def tree(seed: int = 17) -> dict:
    rng = np.random.default_rng(seed)
    params = {}
    for i in range(64):
        dtype = (np.float32, np.int32, np.float16)[i % 3]
        shape = [(3,), (2, 2), ()][i % 3 if i % 7 else 2]
        value = rng.standard_normal(shape) * 10
        params[f"layer_{i:03d}"] = {"w": np.asarray(value).astype(dtype)}
    params["bf16"] = {"w": jnp.asarray(rng.standard_normal((4, 5)), jnp.bfloat16)}
    # Above orbax's 1024-byte inline limit after zstd: held by reference.
    params["big"] = {"kernel": rng.standard_normal((20, 16)).astype(np.float32),
                     "bias": rng.standard_normal(600).astype(np.float16)}
    mu = {k: np.zeros_like(np.asarray(v["w"], np.float32)) + 0.5 for k, v in
          list(params.items())[:30]}
    opt_state = [{"count": np.int32(3), "mu": mu}, None, {"count": np.int32(3)}]
    return {"step": np.int32(11), "params": params,
            "batch_stats": {"bn": {"mean": rng.standard_normal(8).astype(np.float32)}},
            "opt_state": opt_state}


def flatten(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from flatten(v, path + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from flatten(v, path + (str(i),))
    else:
        yield "/".join(path), node


def main() -> None:
    data = tree()
    target = os.path.join(OUT, NAME)
    shutil.rmtree(target, ignore_errors=True)
    BestCheckpointer(OUT, NAME).save(types.SimpleNamespace(
        step=data["step"], params=data["params"], batch_stats=data["batch_stats"],
        opt_state=data["opt_state"]))
    arrays, nones = {}, []
    for path, leaf in flatten(data):
        if leaf is None:
            nones.append(path)
        else:
            arr = np.asarray(leaf)
            arrays[path] = arr.astype(np.float32) if arr.dtype == jnp.bfloat16 else arr
    np.savez_compressed(target + ".npz", __none__=np.asarray(nones), **arrays)
    n = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(target) for f in fs)
    print(f"{target}: {len(arrays) + len(nones)} leaves, {n} bytes; {target}.npz "
          f"{os.path.getsize(target + '.npz')} bytes")


if __name__ == "__main__":
    main()
