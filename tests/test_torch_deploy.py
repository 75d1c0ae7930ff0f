"""The port as it is installed and deployed, on the CPU.

* Packaging: a wheel of the tree (``pip wheel --no-deps --no-build-isolation``
  of a copy of the packages) holds every non-``.py`` file of
  ``instageo_tpu_torch/`` (kernel sources, the native decoder's source,
  configs, the SPA, runbooks, notebooks, the deployment), one case per file;
  unpacked and imported in a fresh interpreter from there, it builds the
  native GeoTIFF decoder and decodes with it, nothing with the Python codec.
* The compose files of ``instageo_tpu_torch/deploy/``: each parses to the
  same mapping under the port's YAML reader and under PyYAML; every service
  built from the repo starts the port (its ``command`` imports only
  ``instageo_tpu_torch``, names a callable that exists, on a queue of
  ``ALL_QUEUES``); every environment name a service sets is one the port
  reads; the services whose stage runs on ``INSTAGEO_DEVICE`` reserve the
  GPU and none sets it to the CPU; the services, queues, volumes, restart
  policies, ports and profiles are those of ``deploy/``.
* The Dockerfile copies the port, never ``instageo_tpu/``, and builds the
  kernels and the decoder with no failure swallowed.
"""

import ast
import os
import re
import shlex
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "instageo_tpu_torch"
DEPLOY = PORT / "deploy"
COMPOSE = {"docker-compose.yml": "docker-compose.yml",
           "docker-compose.prod.yml": "docker-compose.prod.yml"}
# Queue -> does its stage run on INSTAGEO_DEVICE (webapp/settings.py DEVICE)?
# Stage 1's chip masking and stage 2's model do; stage 3's COG merge does not.
ON_DEVICE = {"data-processing": True, "model-prediction": True,
             "visualization-preparation": False}
# Port modules that read the environment names a service may set.
ENV_READERS = ("webapp/settings.py", "utils/compile_cache.py", "webapp/main.py",
               "data/settings.py")


def _port_data_files():
    """Every non-``.py`` file of the port in the checkout (git's list where
    there is a repository, else the tree without caches)."""
    proc = subprocess.run(["git", "ls-files", "--cached", "--others", "--exclude-standard",
                           "instageo_tpu_torch"], cwd=REPO,
                          capture_output=True, text=True)
    if proc.returncode == 0 and proc.stdout.strip():
        files = proc.stdout.split()
    else:
        files = [str(p.relative_to(REPO)) for p in PORT.rglob("*") if p.is_file()
                 and "__pycache__" not in p.parts]
    return sorted(f for f in files if not f.endswith((".py", ".pyc")))


DATA_FILES = _port_data_files()


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """A wheel of the tree: the packages, ``pyproject.toml`` and README
    copied (so that the build writes nothing into the checkout), then
    ``pip wheel``."""
    src = tmp_path_factory.mktemp("src")
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src / name)
    for pkg in ("instageo_tpu", "instageo_tpu_torch"):
        shutil.copytree(REPO / pkg, src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so"))
    out = tmp_path_factory.mktemp("dist")
    proc = subprocess.run([sys.executable, "-m", "pip", "wheel", str(src), "--no-deps",
                           "--no-build-isolation", "-w", str(out), "-q"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (path,) = out.glob("*.whl")
    return path


def test_port_has_data_files():
    assert "instageo_tpu_torch/native/geotiff_native.cc" in DATA_FILES
    assert any(f.startswith("instageo_tpu_torch/notebooks/") for f in DATA_FILES)
    assert any(f.startswith("instageo_tpu_torch/deploy/") for f in DATA_FILES)


@pytest.mark.parametrize("rel", DATA_FILES)
def test_wheel_holds_the_port_file(wheel, rel):
    with zipfile.ZipFile(wheel) as z:
        assert rel in z.namelist(), f"the wheel drops {rel}"
        assert z.read(rel) == (REPO / rel).read_bytes()


def test_wheel_names_the_port_entry_points(wheel):
    with zipfile.ZipFile(wheel) as z:
        (ep,) = [n for n in z.namelist() if n.endswith("entry_points.txt")]
        text = z.read(ep).decode()
    assert "instageo-torch-run = instageo_tpu_torch.train.run:main" in text
    assert "instageo-torch-serve = instageo_tpu_torch.webapp.main:main" in text


INSTALLED = """\
import json, os, sys
import numpy as np
import instageo_tpu_torch
from instageo_tpu_torch import native
from instageo_tpu_torch.data import dataloader
from instageo_tpu_torch.data.geotiff import Affine, write_geotiff

target, work = sys.argv[1], sys.argv[2]
assert instageo_tpu_torch.__file__.startswith(target), instageo_tpu_torch.__file__
rng = np.random.default_rng(0)
paths, want = [], []
for i in range(2):
    arr = rng.integers(0, 10000, size=(3, 40, 48)).astype(np.uint16)
    p = os.path.join(work, f"chip_{i}.tif")
    write_geotiff(p, arr, transform=Affine.from_origin(0, 0, 30, 30), crs=32633)
    paths.append(p)
    want.append(arr)
ok = native.available()
got = native.read_batch_native(paths, (3, 40, 48), np.uint16) if ok else None
full = [dataloader._read_full(p) for p in paths]
print(json.dumps(dict(
    available=ok, reason=native.unavailable_reason,
    lib=str(native.lib_path()), source=str(native.SOURCE),
    batch_equal=bool(got is not None and np.array_equal(got, np.stack(want))),
    full_equal=all(np.array_equal(a, b) for a, b in zip(full, want)),
    decodes=native.decodes.count, fallback_decodes=native.fallback_decodes.count)))
"""


def test_installed_wheel_decodes_with_the_native_decoder(wheel, tmp_path):
    """ROADMAP fault 10: an installed copy held no ``geotiff_native.cc``, so its
    decoder never built and every loader fell back to the Python codec."""
    import json

    target, work, cache = tmp_path / "site", tmp_path / "work", tmp_path / "cache"
    work.mkdir()
    with zipfile.ZipFile(wheel) as z:
        z.extractall(target)
    env = {k: v for k, v in os.environ.items() if k not in ("INSTAGEO_COMPILE_CACHE",)}
    env.update(PYTHONPATH=str(target), INSTAGEO_COMPILE_CACHE_DIR=str(cache))
    proc = subprocess.run([sys.executable, "-c", INSTALLED, str(target), str(work)], cwd=work,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["source"].startswith(str(target)) and rec["lib"].startswith(str(cache))
    assert rec["available"], rec["reason"]
    assert rec["batch_equal"] and rec["full_equal"]
    assert rec["decodes"] == 4 and rec["fallback_decodes"] == 0


# --- compose -----------------------------------------------------------------


def _port_yaml(name):
    from instageo_tpu_torch.configs.config import loads

    return loads((DEPLOY / name).read_text())


def _services(name):
    return _port_yaml(name)["services"]


SERVICES = [(f, s) for f in COMPOSE for s in _services(f)]
BUILT = [(f, s) for f, s in SERVICES if "build" in _services(f)[s]]


@pytest.mark.parametrize("name", list(COMPOSE))
def test_compose_parses_the_same_under_pyyaml(name):
    yaml = pytest.importorskip("yaml")
    text = (DEPLOY / name).read_text()
    assert not re.search(r"<<:|(:|^\s*-)\s*[&*]\w", text, re.M), "anchors or merge keys"
    assert _port_yaml(name) == yaml.safe_load(text)


@pytest.mark.parametrize("name,service", BUILT, ids=[f"{f}:{s}" for f, s in BUILT])
def test_service_starts_the_port(name, service):
    """The command is ``python -m instageo_tpu_torch.webapp.main`` or a
    ``python -c`` program that imports only the port and calls
    ``worker_loop`` on a queue of ``ALL_QUEUES``; the image is the port's."""
    import importlib

    from instageo_tpu_torch.webapp.queue import ALL_QUEUES

    svc = _services(name)[service]
    assert svc["build"] == {"context": "../..",
                            "dockerfile": "instageo_tpu_torch/deploy/Dockerfile"}
    assert (DEPLOY / svc["build"]["context"] / svc["build"]["dockerfile"]).resolve() \
        == DEPLOY / "Dockerfile"
    argv = shlex.split(svc["command"])
    assert argv[0] == "python"
    if argv[1] == "-m":
        assert argv[2:] == ["instageo_tpu_torch.webapp.main"]
        assert callable(importlib.import_module(argv[2]).main)
        return
    assert argv[1] == "-c" and len(argv) == 3
    tree = ast.parse(argv[2])
    calls = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert node.module.split(".")[0] == "instageo_tpu_torch", node.module
            for alias in node.names:
                assert callable(getattr(importlib.import_module(node.module), alias.name))
        elif isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] == "instageo_tpu_torch" for a in node.names)
        elif isinstance(node, ast.Call):
            calls.append(node)
    (call,) = calls
    assert call.func.id == "worker_loop" and len(call.args) == 1
    assert call.args[0].value in ALL_QUEUES
    assert service == {"data-processing": "worker-data-processing",
                       "model-prediction": "worker-model-prediction",
                       "visualization-preparation": "worker-visualization"}[call.args[0].value]


def _environment(svc):
    env = svc.get("environment") or {}
    if isinstance(env, list):
        env = dict(e.split("=", 1) for e in env)
    return env


@pytest.mark.parametrize("name,service", SERVICES, ids=[f"{f}:{s}" for f, s in SERVICES])
def test_service_environment_is_read_by_the_port(name, service):
    read = "\n".join((PORT / m).read_text() for m in ENV_READERS)
    for key in _environment(_services(name)[service]):
        assert f'"{key}"' in read, f"{service} sets {key}, which the port does not read"


def _queue_of(svc):
    m = re.search(r"worker_loop\('([^']+)'\)", svc.get("command", ""))
    return m.group(1) if m else None


@pytest.mark.parametrize("name,service", SERVICES, ids=[f"{f}:{s}" for f, s in SERVICES])
def test_service_reserves_the_gpu_where_its_stage_runs_on_the_device(name, service):
    svc = _services(name)[service]
    env = _environment(svc)
    assert "cpu" not in str(env.get("INSTAGEO_DEVICE", "")).lower()
    devices = (svc.get("deploy") or {}).get("resources", {}).get("reservations", {}) \
        .get("devices", [])
    queue = _queue_of(svc)
    if queue is not None and ON_DEVICE[queue]:
        assert devices == [{"driver": "nvidia", "count": 1, "capabilities": ["gpu"]}]
        assert env.get("INSTAGEO_DEVICE") == "${INSTAGEO_DEVICE:-cuda}"
    else:
        assert devices == [] and "INSTAGEO_DEVICE" not in env


@pytest.mark.parametrize("name", list(COMPOSE))
def test_compose_has_the_jax_topology(name):
    """The services, their queues, volumes, restart policies, ports and
    profiles are those of ``deploy/`` (read with PyYAML: the JAX prod file
    uses anchors)."""
    yaml = pytest.importorskip("yaml")
    jax = yaml.safe_load((REPO / "deploy" / COMPOSE[name]).read_text())
    port = _port_yaml(name)
    assert sorted(port["services"]) == sorted(jax["services"])
    assert port["volumes"] == jax["volumes"]
    keys = ("volumes", "restart", "ports", "expose", "profiles", "depends_on", "image")
    for service, want in jax["services"].items():
        got = port["services"][service]
        assert _queue_of(got) == _queue_of(want), service
        for key in keys:
            if key == "image" and "build" in want:
                continue  # the port's image has its own name
            assert got.get(key) == want.get(key), (service, key)
        replicas = (want.get("deploy") or {}).get("replicas")
        assert (got.get("deploy") or {}).get("replicas") == \
            (None if replicas is None else str(replicas)), service
        if "build" not in want:
            assert got.get("command") == want.get("command"), service


def test_deploy_script_parses():
    proc = subprocess.run(["bash", "-n", str(DEPLOY / "deploy.sh")], capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stderr
    assert os.access(DEPLOY / "deploy.sh", os.X_OK)


# --- the image ---------------------------------------------------------------


def _dockerfile_instructions():
    """(instruction, arguments) per Dockerfile instruction, continuations joined."""
    text = re.sub(r"\\\n", " ", (DEPLOY / "Dockerfile").read_text())
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            word, _, rest = line.partition(" ")
            out.append((word.upper(), rest.strip()))
    return out


def test_dockerfile_copies_the_port_only():
    copies = [args for word, args in _dockerfile_instructions() if word in ("COPY", "ADD")]
    sources = [s for args in copies for s in args.split()[:-1]]
    assert "instageo_tpu_torch" in sources
    assert not any(s.rstrip("/") in ("instageo_tpu", ".") for s in sources), sources


def test_dockerfile_builds_kernels_and_decoder_and_swallows_no_failure():
    ins = _dockerfile_instructions()
    base = next(args for word, args in ins if word == "FROM")
    assert base.startswith("nvidia/cuda:") and "devel" in base
    runs = [args for word, args in ins if word == "RUN"]
    assert not any("|| true" in r or "|| :" in r for r in runs), runs
    assert any("pip install --no-deps ." in r for r in runs)
    assert any("_build.build(_build.sources())" in r for r in runs)
    assert any("native.build()" in r for r in runs)
    env = " ".join(args for word, args in ins if word == "ENV")
    assert re.search(r"INSTAGEO_COMPILE_CACHE_DIR=/\S+", env)
    assert ins[-1] == ("CMD", '["python", "-m", "instageo_tpu_torch.webapp.main"]')
