"""Run one cell of the benchmark (see ``vhbench/harness.py``):

    python3 vhbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The process keeps its load steady: torch's CPU work on one thread (an idle
thread pool that spins takes cores from the host path the window times)
and the process on the last two cores it may use (so that the scheduler
does not move the frame loop between cores).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    os.environ["OMP_NUM_THREADS"] = "1"
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from vhbench import harness
    sys.exit(harness.main(t_start=T_START))
