"""Run one cell of the benchmark once and print its result as the last line.

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Needs as many CUDA cards as the cell asks for; exits non-zero without
them, and prints no result.  See ``perfbench/harness.py``.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
