"""Readings of a cell whose traffic kind names its own stand-ins (the kind
module's ``CONTROLS``), which the table of ``readings.py`` does not list:

    python3 h100bench/kind_readings.py --workload <cell> --seeds 1,2,3 \\
        [--control <control>] [--seconds 4] [--out readings.jsonl]

The rows are ``readings.py``'s: this adds the cell's kind and its controls
to that table and runs its ``readings``. The kinds say what each stand-in
puts in the program's place (``kinds/serve_closed_tl.py``).
"""

import argparse
import os
import sys
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main() -> int:
    from h100bench import env

    env.set_up()
    from h100bench import harness, readings

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out")
    a = p.parse_args()
    root = Path(HERE).parent
    cell = harness.find_cell(harness.load_benchmark(root), a.workload)
    kind = harness.cell_files(root, cell)["traffic"]["kind"]
    readings.CONTROLS.setdefault(kind, tuple(harness.kind_module(root, kind).CONTROLS))
    readings.readings(a.workload, [int(s) for s in a.seeds.split(",")], a.control, a.seconds,
                      out=a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
