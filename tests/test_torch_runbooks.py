"""The port's replication runbooks against the JAX ones.

``instageo_tpu_torch/experiments/`` holds a twin of every runbook of
``experiments/``: the same file, line for line, after ``RENAME`` (the
package's name, the runbooks' own path inside it, the ``cd`` to the
repository root one level deeper, and the hardware the comment names), and
executable as the JAX one is.

No runbook runs here: each trains on a published dataset the repository
does not hold. What is checked is what each command line asks of the two
packages. Every ``python -m <package>.train.run`` line, its shell variables
set to the runbook's defaults (and sample statistics where it reads them
from ``mode=stats``), resolves to the same config through each package's
``load_config_from_argv``, in order: a line with ``run_dir`` saves its
config as ``run.py`` does (``save_config``), and a later ``--config-path
<run_dir>/.hydra --config-name=config`` line re-enters through the file its
own package saved. Every data CLI line parses through the port's flag table
(a flag it does not take exits), each flag it gives to the value absl's
``FLAGS`` give the JAX CLI. A script a runbook calls exists at its renamed path.
"""

import os
import re
import shlex
import stat
from pathlib import Path

import pytest

from instageo_tpu.configs import config as jax_config
from instageo_tpu.data import chip_creator as jax_chip_creator
from instageo_tpu.data import raster_chip_creator as jax_raster_chip_creator
from instageo_tpu_torch.configs import config as port_config
from instageo_tpu_torch.data import flags as port_flags

REPO = Path(__file__).resolve().parent.parent
JAX_DIR = REPO / "experiments"
PORT_DIR = REPO / "instageo_tpu_torch" / "experiments"
RENAME = [
    (r"\binstageo_tpu\b", "instageo_tpu_torch"),
    (r"(?<![\w/])experiments/", "instageo_tpu_torch/experiments/"),
    (r'\$\(dirname "\$0"\)/\.\.', '$(dirname "$0")/../..'),
    (r"\bon TPU\b", "on the card"),
]
RUNBOOKS = sorted(str(p.relative_to(JAX_DIR)) for p in JAX_DIR.rglob("*.sh"))
# What the runbooks read from the environment or from mode=stats, where they
# have no default of their own.
SHELL = {"MEAN": "431.5,823.25,760.0,2950.5,2035.75,1234.0",
         "STD": "100.5,121.25,150.0,540.5,400.0,380.75",
         "CW": "0.5,1.25,2.0,1.0,0.75,3.0,1.5,2.5,0.25,1.0,1.75,0.5,2.25",
         "GCS_BUCKET": "gs://bucket", "PRITHVI_PRETRAINED_PATH": "/weights/Prithvi_100M.pt"}
DATA_CLIS = {"chip_creator": (jax_chip_creator, port_flags.COMMON_FLAGS),
             "raster_chip_creator": (jax_raster_chip_creator,
                                     port_flags.COMMON_FLAGS + port_flags.RASTER_FLAGS)}


def rename(line: str) -> str:
    for pattern, replacement in RENAME:
        line = re.sub(pattern, replacement, line)
    return line


def test_every_runbook_has_its_twin():
    ours = sorted(str(p.relative_to(PORT_DIR)) for p in PORT_DIR.rglob("*.sh"))
    assert ours == RUNBOOKS and len(RUNBOOKS) == 10


@pytest.mark.parametrize("name", RUNBOOKS)
def test_runbook_is_its_jax_twin_renamed(name):
    jax_text, port_text = (JAX_DIR / name).read_text(), (PORT_DIR / name).read_text()
    jax_lines, port_lines = jax_text.splitlines(), port_text.splitlines()
    assert len(port_lines) == len(jax_lines)
    for i, (a, b) in enumerate(zip(jax_lines, port_lines), 1):
        assert rename(a) == b, f"{name}:{i}"
    assert port_text.endswith("\n") == jax_text.endswith("\n")
    assert "instageo_tpu." not in port_text.replace("instageo_tpu_torch.", "")
    mode = (JAX_DIR / name).stat().st_mode & stat.S_IXUSR
    assert (PORT_DIR / name).stat().st_mode & stat.S_IXUSR == mode


def _commands(text: str):
    """The runbook's logical lines (continuations joined) and the defaults
    of its ``VAR=${VAR:-default}`` assignments."""
    text = text.replace("\\\n", " ")
    defaults = dict(re.findall(r"\b(\w+)=\$\{\1:-([^}]*)\}", text))
    return [line.strip() for line in text.splitlines()], defaults


def _expand(cmd: str, env: dict) -> list:
    """``cmd`` from ``python -m`` to its first pipe or redirection, its
    variables expanded, as argv."""
    cmd = cmd[cmd.index("python -m"):]
    cmd = re.split(r"\s(?:\||2>&1)", cmd)[0]
    cmd = cmd.replace("$(pwd)", env["PWD"])
    cmd = re.sub(r"\$\{(\w+)\}|\$(\w+)", lambda m: env[m.group(1) or m.group(2)], cmd)
    return shlex.split(cmd)


def _resolve(lines, env: dict, package: str, config, cwd: Path) -> list:
    """Each train.run line's resolved config (as a dict), in order; a line
    with ``run_dir`` saves its config under ``cwd`` as the CLI does."""
    out = []
    for line in lines:
        if f"python -m {package}.train.run" not in line:
            continue
        argv = _expand(line, env)[3:]
        cfg = config.load_config_from_argv(argv)
        if cfg.get("run_dir") and cfg.get("mode", "train") in ("train", "replica"):
            config.save_config(cfg, str(cwd / str(cfg.run_dir)))
        out.append(cfg.to_dict())
    return out


@pytest.mark.parametrize("name", [n for n in RUNBOOKS if "train" in (JAX_DIR / n).read_text()
                                  and ".train.run" in (JAX_DIR / n).read_text()])
def test_train_lines_resolve_to_the_same_config(name, tmp_path):
    resolved = {}
    for package, directory, config in (("instageo_tpu", JAX_DIR, jax_config),
                                       ("instageo_tpu_torch", PORT_DIR, port_config)):
        cwd = tmp_path / package
        cwd.mkdir()
        lines, defaults = _commands((directory / name).read_text())
        env = {**defaults, **SHELL, "PWD": str(cwd)}
        resolved[package] = _resolve(lines, env, package, config, cwd)
    assert resolved["instageo_tpu_torch"] == resolved["instageo_tpu"]
    assert len(resolved["instageo_tpu"]) >= 1


@pytest.mark.parametrize("name", [n for n in RUNBOOKS if "_chip_creator" in
                                  (JAX_DIR / n).read_text()
                                  or "data.chip_creator" in (JAX_DIR / n).read_text()])
def test_data_cli_lines_parse_to_the_jax_flags(name):
    lines, defaults = _commands((PORT_DIR / name).read_text())
    env = {**defaults, **SHELL, "PWD": "/work", "split": "train", "dir": "training_chips"}
    parsed = 0
    for line in lines:
        m = re.search(r"python -m instageo_tpu_torch\.data\.(\w+)", line)
        if not m:
            continue
        jax_module, table = DATA_CLIS[m.group(1)]
        args = _expand(line, env)[3:]
        ours = port_flags.parse_flags(args, table)
        flags = jax_module.FLAGS
        flags.unparse_flags()
        given = {a[2:].split("=", 1)[0] for a in args if a.startswith("--")}
        assert ours.present == given
        try:
            flags(["prog"] + args)
            # The flags the line gives (a default can differ in absl's
            # process-wide registry, where the JAX data cleaner registers
            # window_size with its own; tests/test_torch_geo.py holds them).
            for f in given:
                assert getattr(ours, f) == flags[f].value, (name, f)
        finally:
            flags.unparse_flags()
        parsed += 1
    assert parsed >= 1


@pytest.mark.parametrize("name", RUNBOOKS)
def test_scripts_a_runbook_calls_exist(name):
    text = (PORT_DIR / name).read_text()
    for script in re.findall(r"(?:python|bash) (instageo_tpu_torch/experiments/\S+)", text):
        assert (REPO / script).is_file(), script
