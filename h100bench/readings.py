"""The readings that a cell's limits are set from, many seeds in one
process:

    python3 h100bench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control <control>] [--seconds 4] [--out readings.jsonl]

Each seed runs the cell's traffic kind (set-up, a window of ``--seconds``, the
comparison) and prints the numbers compared. Without ``--control`` the
program runs: its readings give a limit's lower end. ``--control`` puts a
stand-in in the program's place, whose readings give the upper end. A
serving cell takes ``int8``: the program's own int8 path (``tpu.quant:
int8``). A training cell takes the reference in the program's place:
``fp8``, with float8 e4m3 wherever the program holds bf16; ``half_batch``,
with the loss taken over half of each micro-batch; ``stale_group``, with
the last group of steps trained on the batches of the group before;
``group_unchanged``, with the last group leaving the state as it found it.
A training cell needs no window (``--seconds 0``).
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


CONTROLS = {"serve_closed": ("int8",), "train_epoch": ("fp8", "half_batch", "stale_group",
                                                           "group_unchanged")}


def readings(workload, seeds, control=None, seconds=0.0, device="cuda", root=None,
             out=None):
    """[{seed, control, numbers, metrics, notes}] of each seed."""
    from pathlib import Path

    import torch

    from h100bench import harness
    from h100bench.common import Context

    root = Path(root) if root is not None else Path(HERE).parent
    bench = harness.load_benchmark(root)
    cell = harness.find_cell(bench, workload)
    files = harness.cell_files(root, cell)
    kind = files["traffic"]["kind"]
    if control is not None and control not in CONTROLS.get(kind, ()):
        raise ValueError(f"a {kind} cell takes the controls {CONTROLS.get(kind, ())}, "
                         f"not {control!r}")
    run = harness.kind_module(root, kind).run
    rows = []
    for seed in seeds:
        ctx = Context(cell=workload, config=files["config"], traffic=files["traffic"],
                      limits=files["limits"], seed=int(seed), seconds=float(seconds),
                      trace=False, device=torch.device(device),
                      t_process=time.perf_counter(), control=control)
        res = run(ctx)
        row = {"workload": workload, "seed": int(seed), "control": control,
               "numbers": res["numbers"],
               "correct": res["correct"], "metrics": res["metrics"], "notes": ctx.notes}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        del res, ctx
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return rows


def main() -> int:
    from h100bench import env

    env.set_up()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", choices=sorted({c for cs in CONTROLS.values() for c in cs}))
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out")
    a = p.parse_args()
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.control, a.seconds,
             out=a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
