"""The port's notebook walkthroughs (``instageo_tpu_torch/notebooks/``), on the CPU.

* They equal ``tools/gen_torch_notebooks.py``'s output byte for byte, under
  the JAX notebooks' five names, and are valid nbformat v4 with cell ids.
* Their code never imports JAX, the JAX package or pandas, and every cell
  that places work passes the setup cell's ``DEVICE`` on.
* Each runs in a fresh interpreter, as Restart & Run All runs it, with
  ``INSTAGEO_DEVICE=cpu``, and prints its marker (the JAX notebook's, with
  ``predict.pt2`` for ``InstaGeo_Demo``). The five start together, one case
  each.
* ``InstaGeo_Demo`` against ``notebooks/InstaGeo_Demo.ipynb``, both run in
  this process with the run CLI and the map recorded, not run (as
  ``tests/test_torch_examples_train.py`` holds the quickstart): the chips and
  CSV its cells write are the JAX notebook's byte for byte, and each
  ``run_main`` argv is the JAX one's with ``device=cpu`` added and the
  artifact's name changed, resolving to the same config through each
  package's ``load_config_from_argv``.
"""

import ast
import json
import os
import signal
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NB_DIR = os.path.join(REPO, "instageo_tpu_torch", "notebooks")
JAX_NB_DIR = os.path.join(REPO, "notebooks")
MARKERS = {
    "chip_creator_demo.ipynb": "cloud-masked corner is no-data: True",
    "data_cleaner_demo.ipynb": "labeled pixels per seg map after limiting",
    "data_splitter_demo.ipynb": "splits_locations.png",
    "raster_chip_creator_demo.ipynb": "2 chips + 2 seg maps",
    "InstaGeo_Demo.ipynb": "predict.pt2",
}
NOTEBOOKS = sorted(MARKERS)
RUN_TIMEOUT_S = 240


def _generator():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import gen_torch_notebooks
    finally:
        sys.path.pop(0)
    return gen_torch_notebooks


def _script(path):
    """The code cells, concatenated: what a kernel runs top to bottom."""
    with open(path) as f:
        nb = json.load(f)
    return "\n\n".join("".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code")


def test_notebooks_match_generator():
    gen = _generator()
    assert sorted(gen.NOTEBOOKS) == NOTEBOOKS == sorted(os.listdir(JAX_NB_DIR))
    assert sorted(os.listdir(NB_DIR)) == NOTEBOOKS
    for name in NOTEBOOKS:
        with open(os.path.join(NB_DIR, name)) as f:
            assert f.read() == gen.render(name), (
                f"{name} drifted from tools/gen_torch_notebooks.py — edit the generator "
                "and re-run it")


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_is_valid_nbformat(name):
    nbformat = pytest.importorskip("nbformat")
    nb = nbformat.read(os.path.join(NB_DIR, name), as_version=4)
    nbformat.validate(nb)
    assert {c.cell_type for c in nb.cells} == {"markdown", "code"}
    assert all(c.get("id") for c in nb.cells)


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_imports_neither_jax_nor_pandas(name):
    banned = ("jax", "flax", "instageo_tpu", "pandas")
    for node in ast.walk(ast.parse(_script(os.path.join(NB_DIR, name)))):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in banned, f"{name} imports {mod}"


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_places_work_on_its_device(name):
    """The setup cell reads ``INSTAGEO_DEVICE`` (``cuda`` by default); each
    run CLI argv carries ``device={DEVICE}`` and each chip creator call
    ``--device={DEVICE}``; nothing names the CPU."""
    script = _script(os.path.join(NB_DIR, name))
    assert 'DEVICE = os.environ.get("INSTAGEO_DEVICE", "cuda")' in script
    tree = ast.parse(script)
    assert not [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
                and isinstance(n.value, str) and "cpu" in n.value.lower()]
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)]
    cli = [c for c in calls if isinstance(c.func, ast.Attribute) and c.func.attr == "main"
           and isinstance(c.func.value, ast.Name)
           and c.func.value.id in ("chip_creator", "raster_chip_creator")]
    for c in cli:
        assert "--device={DEVICE}" in ast.unparse(c), ast.unparse(c)
    if "run_main" in script:
        assert 'f"device={DEVICE}"' in script
        for c in calls:
            if isinstance(c.func, ast.Name) and c.func.id == "run_main":
                assert "common" in ast.unparse(c)
    if name in ("chip_creator_demo.ipynb", "data_cleaner_demo.ipynb",
                "raster_chip_creator_demo.ipynb"):
        assert cli or "--device={DEVICE}" in script


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every notebook's code in a fresh interpreter of its own, all started
    together, each a process group of its own."""
    procs = {}
    for name in NOTEBOOKS:
        tmp = tmp_path_factory.mktemp(name.split(".")[0])
        path = tmp / "nb_script.py"
        path.write_text(_script(os.path.join(NB_DIR, name)))
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        # The raster pipeline's tile cache can load one tile several times at
        # once; at 30 asset loads a minute a small run would stall (ROADMAP fault 9).
        env.update(INSTAGEO_DEVICE="cpu", DEMO_DIR=str(tmp / "work"), OMP_NUM_THREADS="1",
                   INSTAGEO_COG_RATELIMIT="1000")
        procs[name] = subprocess.Popen(
            [sys.executable, str(path)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_code_cells_execute(started, name):
    proc = started[name]
    try:
        out, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, out[-4000:]
    assert "Traceback" not in out, out[-4000:]
    assert MARKERS[name] in out, out[-4000:]
    assert "device: cpu" in out


def _recorded_run(script, work, run_module, viz_module, monkeypatch):
    """Run ``script`` (a notebook's code) in this process with the run CLI
    and the map recorded: each ``run_main`` argv, in order, and the files it
    leaves in ``work``."""
    calls = []

    def run_main(argv):
        calls.append(list(argv))
        if argv[0] == "mode=eval":
            return {"test_Acc": 0.0, "test_IoU": 0.0}
        if argv[0] == "mode=export":
            path = next(a.split("=", 1)[1] for a in argv if a.startswith("export.path="))
            open(path, "wb").close()
            return path
        return {}

    monkeypatch.setattr(run_module, "main", run_main)
    monkeypatch.setattr(viz_module, "create_map_with_geotiff_tiles",
                        lambda preds, path, **kw: path)
    monkeypatch.setenv("DEMO_DIR", str(work))
    monkeypatch.setattr(sys, "path", list(sys.path))
    exec(compile(script, "<notebook>", "exec"), {"__name__": "__notebook__"})
    files = {f: (work / f).read_bytes() for f in sorted(os.listdir(work))
             if not f.startswith("predict.")}
    return calls, files


def test_instageo_demo_writes_the_jax_dataset_and_resolves_the_jax_configs(tmp_path,
                                                                           monkeypatch):
    from instageo_tpu.apps import viz as jax_viz
    from instageo_tpu.configs import config as jax_config
    from instageo_tpu.train import run as jax_run
    from instageo_tpu_torch.apps import viz as port_viz
    from instageo_tpu_torch.configs import config as port_config
    from instageo_tpu_torch.train import run as port_run

    monkeypatch.chdir(REPO)
    monkeypatch.setenv("INSTAGEO_DEVICE", "cpu")
    jax_calls, jax_files = _recorded_run(
        _script(os.path.join(JAX_NB_DIR, "InstaGeo_Demo.ipynb")), tmp_path / "jax", jax_run,
        jax_viz, monkeypatch)
    calls, files = _recorded_run(
        _script(os.path.join(NB_DIR, "InstaGeo_Demo.ipynb")), tmp_path / "port", port_run,
        port_viz, monkeypatch)

    assert len(files) == 33 and files == jax_files  # 16 chips, 16 labels, train.csv
    assert [c[0] for c in jax_calls] == ["mode=train", "mode=eval", "mode=chip_inference",
                                         "mode=export"]
    assert len(calls) == len(jax_calls)
    for argv, jax_argv in zip(calls, jax_calls):
        argv = [a.replace(str(tmp_path / "port"), str(tmp_path / "jax")) for a in argv]
        assert argv.count("device=cpu") == 1
        assert [a.replace("predict.pt2", "predict.stablehlo") for a in argv
                if a != "device=cpu"] == jax_argv
        cfg = port_config.load_config_from_argv(argv).to_dict()
        assert cfg.pop("device") == "cpu"
        if "export" in cfg:
            cfg["export"]["path"] = cfg["export"]["path"].replace("predict.pt2",
                                                                  "predict.stablehlo")
        assert cfg == jax_config.load_config_from_argv(jax_argv).to_dict(), argv[0]
