"""Run one benchmark cell once and print its result line.

  python3 benchmarks/run.py --workload tpu.replay --seed 7 --seconds 40 \
      --trace 0

Set-up is timed from this process's start, so the clock is read before
anything heavy is imported.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))
