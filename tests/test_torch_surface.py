"""The port offers what the JAX package offers: its files and public names.

For every Python module of ``instageo_tpu/``, ``examples/`` and
``experiments/``, the public top-level functions and classes, and the
public methods of those classes, are read with ``ast`` (nothing of the JAX
package is imported). The port module of the same path
(``instageo_tpu_torch/``, ``instageo_tpu_torch/examples/``,
``instageo_tpu_torch/experiments/``) must bind each name at its top level,
or in the class's body: a definition, an assignment or an import. The
exceptions are ``JAX_ONLY``: each names its port counterpart (or None) and
why the name itself has none. The file lists of the three pairs are equal
but for ``PORT_ONLY_FILES`` and ``JAX_ONLY_FILES``, each with its reason.
The two user surfaces outside the packages have their twins inside the
port's: the notebooks (``notebooks/`` and ``instageo_tpu_torch/notebooks/``,
the same file names, their generators ``tools/gen_notebooks.py`` and
``tools/gen_torch_notebooks.py`` binding the same public names) and the
deployment (``deploy/`` with the root ``Dockerfile``, and
``instageo_tpu_torch/deploy/``, the same file list).
"""

import ast
import fnmatch
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PAIRS = [("instageo_tpu", "instageo_tpu_torch"),
         ("examples", "instageo_tpu_torch/examples"),
         ("experiments", "instageo_tpu_torch/experiments")]
# The port's own subdirectories that mirror the pairs after the first, and
# the surfaces of ``SURFACES``.
NESTED = ("examples/", "experiments/", "notebooks/", "deploy/")
# (JAX files, relative to the repo; their port directory). The JAX side of
# the deployment is ``deploy/`` and the image's root ``Dockerfile``.
SURFACES = {"notebooks": (("notebooks",), "instageo_tpu_torch/notebooks"),
            "deploy": (("deploy", "Dockerfile"), "instageo_tpu_torch/deploy")}
# (JAX tool, its port twin): the public names of the first are bound in the
# second.
TOOL_PAIRS = [("tools/gen_notebooks.py", "tools/gen_torch_notebooks.py")]

# (JAX module, name) -> (port counterpart, reason). A counterpart is
# "module.py:name" in the port, a dotted torch name, or None.
JAX_ONLY = {
    ("data/flags.py", "define_common_flags"): (
        "data/flags.py:COMMON_FLAGS",
        "absl registers flags in one process-wide registry; the port's table is parsed per call"),
    ("models/checkpoint.py", "vit_params_from_torch"): (
        "models/checkpoint.py:filter_checkpoint_vit",
        "builds a flax param tree; the port's keys are the reference's, so cleaning the dict "
        "is the conversion"),
    ("models/checkpoint.py", "vit_params_to_torch"): (
        None, "the port's encoder state dict is already in the reference's layout"),
    ("models/checkpoint.py", "seg_variables_from_torch"): (
        "models/checkpoint.py:seg_state_dict_from_torch",
        "builds flax variables; the port strips the Lightning prefix"),
    ("models/checkpoint.py", "seg_variables_to_torch"): (
        "models/checkpoint.py:seg_state_dict_from_jax",
        "maps the JAX tree to the reference's keys; the port reads JAX trees with it"),
    ("models/prithvi.py", "LayerNormTPU"): (
        "torch.nn.LayerNorm", "flax LayerNorm with float32 statistics; torch's in float32"),
    ("models/prithvi.py", "QKVProj"): (
        "torch.nn.Linear", "head-structured (D, 3, H, Dh) flax kernel; the port keeps the "
        "reference's fused Linear"),
    ("models/prithvi.py", "stack_block_params"): (
        None, "stacks blocks for lax.scan; the port keeps the loop layout"),
    ("models/seg.py", "ConvTranspose2dTorch"): (
        "torch.nn.ConvTranspose2d", "flax emulation of torch's ConvTranspose2d"),
    ("models/seg.py", "PrithviSeg.setup"): (
        "models/seg.py:PrithviSeg", "flax's submodule hook; the port builds them in __init__"),
    ("models/seg.py", "TPUDropout"): (
        "models/seg.py:Dropout", "the flax module around the Pallas dropout; the port's calls "
        "kernel #6"),
    ("ops/attention.py", "attention_reference"): (
        "ops/attention.py:flash_attention_fwd_plain", "the plain version under its port name"),
    ("ops/attention.py", "blo_supported"): (
        "ops/attention.py:fwd_route", "a TPU block-shape rule; the port routes by head dim"),
    ("ops/attention.py", "pallas_trainable"): (
        None, "a v5e-only rule for when Pallas training pays; every port shape trains on the "
                "kernels"),
    ("ops/quant.py", "QuantDense"): (
        "ops/quant.py:QuantLinear", "flax Dense's int8 twin; the port's replaces nn.Linear"),
    ("parallel/fsdp.py", "fsdp_specs"): (
        "parallel/fsdp.py:fsdp_place", "PartitionSpec trees; FSDP2 places DTensors"),
    ("parallel/mesh.py", "batch_sharding"): (
        "parallel/mesh.py:shard_batch", "a NamedSharding; each rank takes its rows"),
    ("parallel/mesh.py", "replicated"): (
        "parallel/mesh.py:replicate_tree", "a NamedSharding; the port broadcasts from rank 0"),
    ("parallel/mesh.py", "stacked_batch_sharding"): (
        "parallel/mesh.py:shard_stacked_batch", "a NamedSharding; each rank takes its rows"),
    ("parallel/tp.py", "tp_specs"): (
        "parallel/tp.py:tp_place", "PartitionSpecs; parallel/tp.py places by DTensor and "
        "local shards"),
    ("train/checkpointing.py", "migrate_param_tree"): (
        None, "reshapes orbax trees the port never reads"),
    ("train/factory.py", "init_variables"): (
        "train/factory.py:create_model", "flax init; a torch module holds its parameters "
        "from construction"),
    ("train/trainer.py", "TrainState"): (
        "train/trainer.py:Trainer", "flax's state pytree; the trainer holds module and "
        "optimizer"),
}
# Port files with no JAX twin (globs, relative to instageo_tpu_torch/).
PORT_ONLY_FILES = {
    "device.py": "resolve_device: cuda unless the caller asks for the CPU",
    "ops/_build.py": "nvcc at first use, launch counters, CUDA graphs",
    "ops/csrc/*": "the Hopper kernels' CUDA sources",
    "data/table.py": "records without pandas",
    "data/parquet.py": "Parquet without pyarrow",
    "data/jp2.py": "libopenjp2 by ctypes in place of OpenCV",
    "webapp/png.py": "a PNG encoder in place of PIL",
    "webapp/web.py": "the small aiohttp stand-in",
}
# JAX files with no port twin (globs, relative to instageo_tpu/).
JAX_ONLY_FILES = {
    "*/README.md": "the subpackages' notes on the JAX design",
    "native/Makefile": "the port's native decoder is built by g++ at first use",
    "native/libinstageo_native.so": "a JAX build output (ignored by git)",
}


def _files(root: Path, skip=()) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts and p.suffix != ".pyc"
            and not str(p.relative_to(root)).startswith(skip)}


def _matches(path: str, patterns) -> bool:
    return any(fnmatch.fnmatch(path, pat) for pat in patterns)


def _public_names(path: Path) -> set:
    """Public top-level functions and classes, and their public methods."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not m.name.startswith("_")}
    return out


def _bindings(body) -> set:
    out = set()
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _bound_names(path: Path) -> set:
    """What a module binds at its top level, and in each class's body."""
    body = ast.parse(path.read_text()).body
    out = _bindings(body)
    for node in body:
        if isinstance(node, ast.ClassDef):
            out |= {f"{node.name}.{m}" for m in _bindings(node.body)}
    return out


MODULES = [(jax_root, port_root, str(p.relative_to(REPO / jax_root)))
           for jax_root, port_root in PAIRS for p in sorted((REPO / jax_root).rglob("*.py"))
           if "__pycache__" not in p.parts]


@pytest.mark.parametrize("jax_root,port_root,rel", MODULES,
                         ids=[f"{j}/{r}" for j, _, r in MODULES])
def test_port_module_binds_every_public_name(jax_root, port_root, rel):
    port = REPO / port_root / rel
    assert port.is_file(), f"no port of {jax_root}/{rel}"
    bound = _bound_names(port)
    excused = {name for (mod, name) in JAX_ONLY if jax_root == "instageo_tpu" and mod == rel}
    missing = sorted(_public_names(REPO / jax_root / rel) - bound - excused)
    assert missing == [], f"{port_root}/{rel} lacks {missing}"


def test_jax_only_entries_are_true():
    """Each excused name is public in its JAX module and unbound in the
    port's; each counterpart exists; each entry says why."""
    for (mod, name), (counterpart, reason) in JAX_ONLY.items():
        assert name in _public_names(REPO / "instageo_tpu" / mod), (mod, name)
        assert name not in _bound_names(REPO / "instageo_tpu_torch" / mod), (mod, name)
        assert reason and "\n" not in reason
        if counterpart is None:
            continue
        if ":" in counterpart:
            path, target = counterpart.split(":")
            assert target in _bound_names(REPO / "instageo_tpu_torch" / path), counterpart
        else:
            module, attr = counterpart.rsplit(".", 1)
            assert hasattr(importlib.import_module(module), attr), counterpart


@pytest.mark.parametrize("jax_root,port_root", PAIRS)
def test_file_lists_are_equal_but_for_the_named_lists(jax_root, port_root):
    skip = NESTED if jax_root == "instageo_tpu" else ()
    jax_files = _files(REPO / jax_root)
    port_files = _files(REPO / port_root, skip)
    only_port = sorted(f for f in port_files - jax_files
                       if not (jax_root == "instageo_tpu" and _matches(f, PORT_ONLY_FILES)))
    only_jax = sorted(f for f in jax_files - port_files
                      if not (jax_root == "instageo_tpu" and _matches(f, JAX_ONLY_FILES)))
    assert only_port == [] and only_jax == []


def test_named_file_lists_are_true():
    """Each pattern names files that one package has and the other lacks."""
    jax_files = _files(REPO / "instageo_tpu")
    port_files = _files(REPO / "instageo_tpu_torch", NESTED)
    for pattern in PORT_ONLY_FILES:
        hits = fnmatch.filter(port_files, pattern)
        assert hits and not set(hits) & jax_files, pattern
    for pattern in JAX_ONLY_FILES:  # a build output may be absent
        assert not set(fnmatch.filter(jax_files, pattern)) & port_files, pattern
    assert fnmatch.filter(jax_files, "*/README.md")


@pytest.mark.parametrize("surface", list(SURFACES))
def test_surface_file_lists_are_equal(surface):
    jax_paths, port_root = SURFACES[surface]
    jax_files = set()
    for rel in jax_paths:
        path = REPO / rel
        jax_files |= _files(path) if path.is_dir() else {path.name}
    assert jax_files and _files(REPO / port_root) == jax_files


@pytest.mark.parametrize("jax_tool,port_tool", TOOL_PAIRS)
def test_tool_binds_every_public_name(jax_tool, port_tool):
    want = _public_names(REPO / jax_tool) | {"NOTEBOOKS"}
    missing = sorted(want - _bound_names(REPO / port_tool))
    assert {"render", "main"} <= want and missing == []
