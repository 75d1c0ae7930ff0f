"""No JAX in a run: a fresh interpreter that runs a CPU-sized cell holds
no module whose top-level name is jax, jaxlib, flax, optax, orbax or
instageo_tpu (names compared whole), and the reference alone loads nothing
of instageo_tpu_torch either."""

import json
import subprocess
import sys

from h100bench.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "instageo_tpu"}

RUN = """
import json, sys
sys.path.insert(0, {repo!r})
from h100bench import harness
rc = harness.main(["--workload", "tiny.train", "--seed", "5", "--seconds", "1", "--trace", "0"],
                  root={root!r}, device="cpu")
print(json.dumps({{"rc": rc, "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
from h100bench.common import make_weights, reference_module
cfg = json.load(open({cfg!r}))
ref = reference_module(cfg)
m = cfg["model"]
p = make_weights(ref.param_spec(m), 5, torch.device("cpu"))
x = torch.zeros(1, m["in_chans"], m["num_frames"], m["img_size"], m["img_size"])
ref.logits(p, x, m)
print(json.dumps({{"tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def _tops(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax(tmp_path):
    root = tiny.make(tmp_path)
    got = _tops(RUN.format(repo=str(tiny.ROOT), root=str(root)))
    assert got["rc"] == 0
    assert "instageo_tpu_torch" in got["tops"]
    assert not FORBIDDEN.intersection(got["tops"])


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    root = tiny.make(tmp_path)
    got = _tops(REFERENCE.format(repo=str(tiny.ROOT),
                                 cfg=str(root / "h100bench" / "configs" / "tiny.json")))
    assert not (FORBIDDEN | {"instageo_tpu_torch"}).intersection(got["tops"])


def test_forbidden_names_are_compared_whole():
    from h100bench import harness

    assert "instageo_tpu" in harness.FORBIDDEN
    before = set(sys.modules)
    sys.modules.setdefault("instageo_tpu_torch_lookalike", sys)
    try:
        assert "instageo_tpu_torch_lookalike" not in harness.forbidden_modules()
    finally:
        if "instageo_tpu_torch_lookalike" not in before:
            del sys.modules["instageo_tpu_torch_lookalike"]
