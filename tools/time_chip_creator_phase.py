"""Time ``chip_smoke.py``'s chip_creator phase of one or more checkouts on one
card, in turns.

    python3 tools/time_chip_creator_phase.py <root> [<root> ...]

Each argument is the root of a checkout: this repository, or another commit
unpacked with ``git archive`` (give ``parent change change parent`` to
compare two commits on the same host). Each runs
``chip_smoke.chip_creator_phase(cuda, ...)`` in a fresh interpreter from its
own root, in the order given, after the kernels and the native decoder are
built (into one build directory that all runs share, so the build is
timed by none). Prints the card's name and power limit, one line per run
(the phase's wall seconds and the parts ``chip_creator_phase`` returns),
and a JSON summary as the last line. Needs a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

CHILD = r"""
import json, sys, time
sys.path.insert(0, ".")
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from instageo_tpu_torch import native
from instageo_tpu_torch.ops import _build
_build.build(_build.sources())
native.available()
t0 = time.perf_counter()
out = chip_smoke.chip_creator_phase(torch.device("cuda"), sys.argv[1])
wall = time.perf_counter() - t0
print("RESULT " + json.dumps({"phase_s": wall, "runs": out["runs"],
                              "raster_s": out["raster"]["wall_s"],
                              "chip_inference_s": out["chip_inference"]["wall_s"]}))
"""


def main(roots) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    build = tempfile.TemporaryDirectory()
    env = {**os.environ, "INSTAGEO_COMPILE_CACHE_DIR": build.name,
           "INSTAGEO_COG_RATELIMIT": "1000"}
    results = []
    for i, root in enumerate(roots):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CHILD, smi], cwd=os.path.abspath(root),
                              env=env, capture_output=True, text=True)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            print(f"run {i} ({root}) failed with exit {proc.returncode}", file=sys.stderr)
            return 1
        r = dict(json.loads(line[len("RESULT "):]), root=root,
                 process_s=time.perf_counter() - t0)
        results.append(r)
        card, cpu = r["runs"]["card"], r["runs"]["cpu"]
        print(f"[{i}] {root}: chip_creator phase {r['phase_s']:.3f} s ({smi}); points "
              f"{card['wall_s']:.3f} s on the card, {cpu['wall_s']:.3f} s on the CPU; "
              f"chip_inference {r['chip_inference_s']:.3f} s; raster "
              f"{r['raster_s']['card']:.3f} s on the card, {r['raster_s']['cpu']:.3f} s on "
              f"the CPU", flush=True)
    build.cleanup()
    print(json.dumps({"card": smi, "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["."]))
