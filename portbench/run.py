"""Run one cell of the port's benchmark once, and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this directory
and the port (``src/repro_torch``).  The last line of standard output is
the result's JSON object; the last lines of standard error are each
compared number beside its limit.  Without a CUDA device, or with fewer
than the cell asks for, it prints no result and exits with a code other
than 0.  See README.md.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# One process with one thread of numerical work: the host's OpenMP / BLAS
# pools would otherwise spin on the cores the Python loop runs on.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from pb.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
