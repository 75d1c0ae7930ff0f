"""The benchmark's command:

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; see ``harness.py``. The program's compile
caches live under ``h100bench/.cache/`` (``env.py``).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    from h100bench import env

    env.set_up()
    from h100bench import common, harness

    sys.exit(harness.main(t_process=common.process_start()))
