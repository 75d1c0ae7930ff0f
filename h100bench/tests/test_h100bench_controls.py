"""On the card: each cell's control, at the cell's own size, comes out not
correct under the cell's limits, and the program itself comes out correct.
A serving cell's control is the program's own int8 path (``tpu.quant:
int8``); a training cell's is the reference computed in float8 in the
program's place. Run with

    python -m pytest --noconftest -p no:cacheprovider -m cuda h100bench/tests
"""

import json

import pytest
import torch

from h100bench.tests import tiny

CONTROLS = {"serve_closed": ("int8", 3.0), "train_epoch": ("fp8", 0.0)}


def _cells():
    return [c["name"] for c in json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_control_fails_and_program_passes(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from h100bench import harness, readings

    bench = harness.load_benchmark(tiny.ROOT)
    kind = harness.cell_files(tiny.ROOT, harness.find_cell(bench, cell))["traffic"]["kind"]
    control, seconds = CONTROLS[kind]
    assert all(r["correct"] for r in readings.readings(cell, [2147000001], None, seconds))
    assert not any(r["correct"] for r in readings.readings(cell, [2147000002], control, seconds))
