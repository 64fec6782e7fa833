"""The benchmark of bwamem_tpu_torch: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Run it from the root of a checkout, on a machine with the cell's CUDA
devices.  See portbench/harness.py and portbench/README.md.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, not this directory, heads the import path
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
